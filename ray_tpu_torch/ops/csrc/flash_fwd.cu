// K2: blocked online-softmax attention forward returning o and lse.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (pl.pallas_call in _fwd). Public layout, read through strides so the
// caller needs no transpose or padding copy:
//   q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (last dim contiguous),
//   o [B, Sq, Hq, D] in q's type, lse [B, Sq, Hq] float32 (contiguous).
// Masks, as in the TPU kernel: kv padding (k_pos < sk); causal relative to
// the end of kv (k_pos <= q_pos + sk - sq); optional segment equality
// (q_seg[b, q_pos] == kv_seg[b, k_pos]). GQA maps q head h to kv head
// h / (Hq / Hkv). A fully masked row writes o = 0 and lse = -1e30, a
// finite sentinel the log-sum-exp merge of paged prefill relies on.
//
// What bounds it on the H100: operations at prefill and training shapes,
// bytes at decode shapes. Prefill attention does 4*D*Sq*Sk/2 (causal)
// operations on O((Sq+Sk)*D) bytes, hundreds of operations per byte, so
// the card's arithmetic is the roofline there. A few q rows over a long
// kv axis (the dense KV cache's one new token) do 2 rep operations per
// K/V element read, and there the kernel has to keep bytes in flight on
// every SM: up to DECODE_MAX_SQ q rows (the wrapper's, from a measurement
// of both designs) the split-KV design below takes K2 in either type
// (flash_fwd_decode_kernel, which also merges its splits; see there).
// Past it, two
// variants of the 64-row design, chosen by the input type:
//   - bf16 (serving and training) is built for Hopper: wgmma on operands
//     in shared memory, filled by TMA through an mbarrier ring, with P
//     kept in registers between the two products and V read MN-major
//     through the descriptor. One warpgroup per 64-row q tile
//     (flash_fwd_wgmma) at every head dim, except at D 256 past 64 q
//     rows: there two warpgroups share each K/V tile of a 128-row q tile
//     and take turns at the tensor cores (flash_fwd_wgmma_pair);
//   - float32 (the exact reference path of the tests) keeps exact scalar
//     FMAs, on register tiles read as 16-byte shared loads with K and V
//     copied in flight by cp.async (flash_fwd_f32, K3's float32 design):
//     one block per (64-row q tile, q head, batch row) of 256 threads,
//     each owning 4 rows of the score tile.
// All loop over 64-row kv tiles, and the causal bound ends the loop
// early. Head dims 16, 32, 64, 96, 128 and 256, each its own instance of
// both variants (the bf16 tiles' layout for each is hopper.cuh's).
// Tried at D 96 and slower there than flash_fwd_wgmma (PERF.md has the
// readings): warpgroups sharing each K/V tile of a 128- or 192-row q tile
// with stages released by mbarriers, a producer warp, and one tile's
// softmax overlapped with the next S product. Not done yet: a TMA store
// of o; reading ctx pages through the block table instead of a gathered
// copy; in the split-KV design, tensor-core products (mma.sync, as K1's)
// and the chunk's kv rows spread over the warps where a block has fewer
// rows than warps.
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // kv rows per iteration
constexpr int kThreads = 256;  // float32 variant: a 16 x 16 thread grid

// ---------------------------------------------------------------------
// float32 variant (the exact reference path): scalar FMAs on float32
// register tiles, K3's float32 design (flash_bwd.cu, bwd_dq_f32) with dP
// gone and dS replaced by the online softmax's P. It is bound by how fast
// it feeds its FMAs: per live pair 2 D FMAs on operands in shared memory.
// One block of 256 threads, a 16 x 16 grid (ty, tx), per (64-row q tile,
// q head, batch row), heaviest q tiles first:
//   - S = Q K^T: thread (ty, tx) owns rows ty + 16 i and kv columns
//     tx + 16 j (i, j < 4) and walks the head dim 4 columns at a time,
//     reading a row's 4 values of q and k as one float4 each (rows padded
//     by 4 floats: the 8 k rows a quarter-warp reads fall in distinct
//     banks, its q row is one broadcast): 8 loads for 64 FMAs;
//   - the online softmax on those registers, a row's 16 owners one
//     half-warp; P goes to the rows' block of shared memory, which only
//     the same warp reads back;
//   - O += P V: rows ty + 16 i and head dims VW tx + 16 VW n + w (float4,
//     float2 or scalar pieces of a v row), reading 4 P columns of a row
//     as one float4: at D 64, 8 loads for 64 FMAs;
//   - copies in flight: Q once, K and V by 16-byte cp.async (4-byte for a
//     view off 16-byte alignment). In two stages tile kb + 1 is copied
//     during tile kb (one block barrier a tile); in one (D 96 and 256) K
//     kb + 1 is copied as soon as S is done (during the softmax and PV),
//     V kb + 1 at the next tile's start (during its S);
//   - shared memory: 104,960 bytes at D 64, 94,464 at D 96 and less
//     below, so two blocks share an SM there (__launch_bounds__ then holds
//     a thread to 128 registers: a few bytes spill at D 32, 64 and 96,
//     chip_smoke.py's F32_SPILLS); 186,880 at D 128 and 217,344 at D 256,
//     one block;
//   - masks only on a tile that crosses the causal limit or the sk edge,
//     or that carries segment ids (a template per case, chosen per tile;
//     see online_softmax below for what ptxas does with one loop
//     predicated on a flag).
template <int D>
struct FwdF32 {
  static constexpr int NT = kThreads, TY = NT / 16;
  static constexpr int A = kBQ / TY;           // rows of a thread
  static constexpr int RS = D + 4;             // padded row stride
  static constexpr int PS = kBK + 4;           // P row stride
  // of the K/V tiles: one at D 256, where two do not fit, and at D 96,
  // where one lets two blocks share an SM (faster on the card than two
  // stages in one block: chip_variants.py)
  static constexpr int STAGES = D == 96 || D > 128 ? 1 : 2;
  static constexpr int DC = D / 16;            // O head dims of a thread
  static constexpr int VW = piece_width(DC);   // a v row's piece
  static constexpr int q = 0;                  // [kBQ][RS]
  static constexpr int k = q + kBQ * RS;       // [STAGES][kBK][RS]
  static constexpr int v = k + STAGES * kBK * RS;   // [STAGES][kBK][RS]
  static constexpr int p = v + STAGES * kBK * RS;   // [kBQ][PS]
  static constexpr int kseg = p + kBQ * PS;    // [STAGES][kBK] int
  static constexpr size_t bytes = 4 * (size_t)(kseg + STAGES * kBK);
  static constexpr int min_blocks = 2 * bytes + 2048 <= 233472 ? 2 : 1;
};
static_assert(FwdF32<256>::bytes <= 232448, "K2 f32 shared memory");

// The online softmax of one kv tile on this thread's A x 4 scores (rows
// ty + TY i, kv columns tx + 16 j, segment ids ks of those columns):
// scale, mask where kMask, update m and l, rescale acc, and write P to
// the rows' block of p_s. A masked score's p is 0, never an exp.
template <int D, bool kMask>
__device__ __forceinline__ void online_softmax_f32(
    float (*s)[4], float (*acc)[D / 16], float* m, float* l, const int* qs,
    const int* ks, float* p_s, int q0, int k0, int sk, int causal,
    int offset, bool segs, float scale, int ty, int tx) {
  using L = FwdF32<D>;
#pragma unroll
  for (int i = 0; i < L::A; ++i) {
    const int qpos = q0 + ty + L::TY * i;
    bool ok[4];
    float mx = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool keep = true;
      if (kMask) {
        const int kpos = k0 + tx + 16 * j;
        keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos + offset;
        if (segs) keep = keep && ks[j] == qs[i];
      }
      ok[j] = keep;
      s[i][j] = keep ? s[i][j] * scale : NEG_INF_F;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = group_max<16>(mx);
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      p_s[(ty + L::TY * i) * L::PS + tx + 16 * j] = pr;
      sum += pr;
    }
    sum = group_sum<16>(sum);
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < L::DC; ++c) acc[i][c] *= alpha;
  }
}

template <int D>
__global__ void __launch_bounds__(FwdF32<D>::NT, FwdF32<D>::min_blocks)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ qseg,
              const int* __restrict__ kseg, int B, int sq, int sk, int hq,
              int hkv, long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, long long o_sb, long long o_ss,
              long long o_sh, int causal, float scale, int vec16) {
  using L = FwdF32<D>;
  constexpr int A = L::A, TY = L::TY, RS = L::RS, PS = L::PS, NT = L::NT;
  constexpr int DC = L::DC, VW = L::VW, NV = DC / VW;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (hq * B));
  const int rest = blockIdx.x % (hq * B);
  const int h = rest % hq, b = rest / hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kBQ, offset = sk - sq;

  extern __shared__ __align__(16) float fwd_smem[];
  float* q_s = fwd_smem + L::q;
  float* p_s = fwd_smem + L::p;
  int* kseg_s = reinterpret_cast<int*>(fwd_smem + L::kseg);
  const float* q_base = q + b * q_sb + h * q_sh;
  const float* k_base = k + b * k_sb + hk * k_sh;
  const float* v_base = v + b * v_sb + hk * v_sh;
  auto load_k = [&](int kb, int st) {  // K tile kb and its kv segment ids
    stage_rows<D, RS, NT>(fwd_smem + L::k + st * kBK * RS, k_base, k_ss,
                          kb * kBK, kBK, sk, vec16);
    if (kseg != nullptr && tid < kBK) {
      const int kpos = kb * kBK + tid;
      kseg_s[st * kBK + tid] = kpos < sk ? kseg[(size_t)b * sk + kpos] : 0;
    }
  };
  auto load_v = [&](int kb, int st) {
    stage_rows<D, RS, NT>(fwd_smem + L::v + st * kBK * RS, v_base, v_ss,
                          kb * kBK, kBK, sk, vec16);
  };

  int n_kb = (sk + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (q0 + kBQ + offset + kBK - 1) / kBK);
  // the first commit group: Q, K 0 and V 0. Then, with two stages, tile
  // kb + 1 at the start of tile kb; with one, V kb at the start of tile kb
  // (kb > 0) and K kb + 1 after its S
  stage_rows<D, RS, NT>(q_s, q_base, q_ss, q0, kBQ, sq, vec16);
  if (n_kb > 0) {
    load_k(0, 0);
    load_v(0, 0);
  }
  cp_async_commit();

  float m[A], l[A], acc[A][DC];
  int qs[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    const int qpos = min(q0 + ty + TY * i, sq - 1);
    qs[i] = qseg != nullptr ? qseg[(size_t)b * sq + qpos] : 0;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = L::STAGES == 2 ? kb & 1 : 0, k0 = kb * kBK;
    const float* k_s = fwd_smem + L::k + st * kBK * RS;
    const float* v_s = fwd_smem + L::v + st * kBK * RS;
    cp_async_wait<0>();  // K kb (and, with two stages, V kb)
    __syncthreads();     // ... visible; every warp is done with tile kb - 1
    if (L::STAGES == 2) {
      if (kb + 1 < n_kb) {
        load_k(kb + 1, st ^ 1);
        load_v(kb + 1, st ^ 1);
      }
    } else if (kb > 0) {
      load_v(kb, 0);
    }
    cp_async_commit();
    int ks[4];  // the kv segment ids of this thread's columns
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ks[j] = kseg != nullptr ? kseg_s[st * kBK + tx + 16 * j] : 0;

    // S = Q K^T: rows ty + TY i, columns tx + 16 j
    float s[A][4];
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = lds4(k_s + (tx + 16 * j) * RS + e);
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float4 qf = lds4(q_s + (ty + TY * i) * RS + e);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qf, kf[j], s[i][j]);
      }
    }
    if (L::STAGES == 1) {
      __syncthreads();  // every warp is done with K kb: refill it
      if (kb + 1 < n_kb) load_k(kb + 1, 0);
      cp_async_commit();
    }

    // P into shared memory; a row's writers and readers are one warp
    const bool segs = kseg != nullptr;
    if (segs || k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + offset))
      online_softmax_f32<D, true>(s, acc, m, l, qs, ks, p_s, q0, k0, sk,
                                  causal, offset, segs, scale, ty, tx);
    else
      online_softmax_f32<D, false>(s, acc, m, l, qs, ks, p_s, q0, k0, sk,
                                   causal, offset, segs, scale, ty, tx);
    if (L::STAGES == 1) {
      cp_async_wait<1>();  // V kb (K kb + 1 may still be in flight)
      __syncthreads();     // ... visible to every thread
    } else {
      __syncwarp();
    }

    // O += P V: rows ty + TY i, head dims VW tx + 16 VW n + w
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[A];
#pragma unroll
      for (int i = 0; i < A; ++i) p4[i] = lds4(p_s + (ty + TY * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* v_row = v_s + (c + cc) * RS + VW * tx;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float vv[VW];
          lds_piece<VW>(v_row + 16 * VW * n, vv);
#pragma unroll
          for (int i = 0; i < A; ++i) {
            const float pv = (&p4[i].x)[cc];
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][n * VW + w] = fmaf(pv, vv[w], acc[i][n * VW + w]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (n_kb = 0: Q's)

#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* o_row = o + b * o_sb + qpos * o_ss + h * o_sh + VW * tx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        o_row[16 * VW * n + w] = acc[i][n * VW + w] / l_safe;
    if (tx == 0) lse[((size_t)b * sq + qpos) * hq + h] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------
// bf16 variant for Hopper: wgmma on operands in shared memory, filled by
// TMA through an mbarrier ring (hopper.cuh). One warpgroup (128 threads)
// per (64-row q tile, q head, batch row); warp w owns rows 16w..16w+15.
// Thread 0 loads the Q tile once and keeps kStages K/V tiles in flight;
// every thread waits on a tile's barrier, runs S = Q K^T (wgmma, Q and K
// K-major as stored), the online softmax on S's accumulator registers in
// base 2 (log2(e) folded into the scale), then O += P V (wgmma with P
// from registers as bf16 and V MN-major through the transpose bit: no
// transposed copy). A tile is masked only where it must be: across the
// causal limit, at the sk edge, or everywhere when segment ids are given
// (the kv tile's ids staged in shared memory one tile ahead). The grid
// runs the q tiles heaviest first.
constexpr int kWgThreads = 128;
constexpr int kStages = 2;  // K/V tiles in flight
using bf16 = __nv_bfloat16;

// A row's lse from its base-2 running max m and sum l (NEG_INF_F for a
// row that saw no kv): rounded product, then rounded sum, so that no
// build contracts them into one fma and every kernel gives the same bits.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.f ? NEG_INF_F : __fadd_rn(__fmul_rn(m, kLn2), logf(l));
}

// The online softmax of one kv tile in base 2, on this thread's 32
// accumulators of S (rows qpos[0] and qpos[1], columns 8j + 2tq + e):
// scale (log2(e) folded in), mask where kMask (a masked score is exactly
// NEG_INF_F, a live one finite), update m and l, rescale acc, and leave P
// in s. Instantiated with and without the masks and chosen per tile: a
// tile that needs none runs its exps back to back. Left to itself, ptxas
// merged the two into one loop predicated on a runtime flag, whose exps
// and sum ran one after another: 3 times the cycles (measured in
// flash_fwd_wgmma_pair, and in flash_fwd_wgmma built for 256 threads).
template <int D, bool kMask>
__device__ __forceinline__ void online_softmax(
    float* s, float* acc, float* m, float* l, const int* qpos, const int* qs,
    const int* ks, const int* kseg, int k0, int sk, int causal, int offset,
    int tq, float scale_log2) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * rr + e];
        if (kMask) {
          const int c = 8 * j + 2 * tq + e, kpos = k0 + c;
          bool keep = kpos < sk;
          if (causal) keep = keep && kpos <= qpos[rr] + offset;
          if (kseg != nullptr) keep = keep && ks[c] == qs[rr];
          x = keep ? x * scale_log2 : NEG_INF_F;
        } else {
          x *= scale_log2;
        }
        mx = fmaxf(mx, x);
      }
    mx = group_max<4>(mx);
    const float m_new = fmaxf(m[rr], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * rr + e];
        x = kMask && x == NEG_INF_F ? 0.f : exp2f(x - m_new);
        sum += x;
      }
    sum = group_sum<4>(sum);
    const float alpha = exp2f(m[rr] - m_new);
    l[rr] = l[rr] * alpha + sum;
    m[rr] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 2 * rr] *= alpha;
      acc[4 * j + 2 * rr + 1] *= alpha;
    }
  }
}

// The head dims at which flash_fwd_wgmma holds Q's fragments in
// registers for S = Q K^T (wgmma with A from registers: the product reads
// K alone from shared memory). At D 96 that is 24 more registers a
// thread (about 152), which three blocks an SM still hold; the other head
// dims keep Q in shared memory (load_afrag takes the 64-byte swizzle only).
__host__ __device__ constexpr bool fwd_q_regs(int d) { return d == 96; }

template <int D>
struct FwdSmem {  // byte offsets into the 1024-aligned shared memory
  static constexpr int tile = kBQ * D * 2;  // a Q, K or V tile (kBQ == kBK)
  static constexpr int q = 0;
  static constexpr int k = tile;                      // kStages K tiles
  static constexpr int v = k + kStages * tile;        // kStages V tiles
  static constexpr int kseg = v + kStages * tile;     // [2][kBK] int
  static constexpr int bars = kseg + 2 * kBK * 4;     // Q, then K/V stages
  static constexpr int bytes = bars + (1 + kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                bf16* __restrict__ o, float* __restrict__ lse,
                const int* __restrict__ qseg, const int* __restrict__ kseg,
                int B, int sq, int sk, int hq, int hkv, long long o_sb,
                long long o_ss, long long o_sh, int causal,
                float scale_log2) {
  using L = FwdSmem<D>;
  constexpr int NO = D / 2;  // output accumulators per thread
  constexpr int KK = D / 16;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (hq * B));
  const int rest = blockIdx.x % (hq * B);
  const int h = rest % hq, b = rest / hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ, offset = sk - sq;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* q_s = smem + L::q;
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  int n_kb = (sk + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (q0 + kBQ + offset + kBK - 1) / kBK);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, L::tile);
    tma_load_tile<D, kBQ>(q_s, &qmap, qbar, q0, h, b);
    for (int s = 0; s < kStages && s < n_kb; ++s) {
      mbar_expect_tx(&full[s], 2 * L::tile);
      tma_load_tile<D, kBK>(k_s + s * L::tile, &kmap, &full[s], s * kBK, hk,
                            b);
      tma_load_tile<D, kBK>(v_s + s * L::tile, &vmap, &full[s], s * kBK, hk,
                            b);
    }
  }
  if (kseg != nullptr && tid < kBK)
    kseg_s[tid] = tid < sk ? kseg[(size_t)b * sk + tid] : 0;

  // this thread's two rows: q0 + 16 warp + g and 8 below
  int qpos[2], qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qpos[rr] = q0 + warp * 16 + g + 8 * rr;
    qs[rr] = qseg != nullptr ? qseg[(size_t)b * sq + min(qpos[rr], sq - 1)]
                             : 0;
  }
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  float acc[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  __syncthreads();  // barriers initialised, first segment ids staged
  mbar_wait(qbar, 0);
  // with fwd_q_regs(D), Q's A fragments, loaded once
  constexpr bool kQRegs = fwd_q_regs(D);
  uint32_t qf[kQRegs ? KK : 1][4];
  if constexpr (kQRegs)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      load_afrag<D, kBQ>(qf[kk], q_s, warp, lane, kk);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages, k0 = kb * kBK;
    const unsigned char* kt = k_s + st * L::tile;
    const unsigned char* vt = v_s + st * L::tile;
    mbar_wait(&full[st], (kb / kStages) & 1);

    // S = Q K^T
    wgmma_fence();
    fence_regs<32>(s);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      if constexpr (kQRegs)
        wgmma_rs_kb64(s, qf[kk], desc_kmajor<D, kBK>(kt, kk), kk > 0);
      else
        wgmma_ss<64>(s, desc_kmajor<D, kBQ>(q_s, kk),
                     desc_kmajor<D, kBK>(kt, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);

    // masks (only where a tile needs them) and the online softmax
    const int* ks = kseg_s + (kb & 1) * kBK;
    if (kseg != nullptr || k0 + kBK > sk ||
        (causal && k0 + kBK - 1 > q0 + offset))
      online_softmax<D, true>(s, acc, m, l, qpos, qs, ks, kseg, k0, sk,
                              causal, offset, tq, scale_log2);
    else
      online_softmax<D, false>(s, acc, m, l, qpos, qs, ks, kseg, k0, sk,
                               causal, offset, tq, scale_log2);

    // O += P V: P from registers, V MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) wg_frag(a[t], s, t);
    wgmma_fence();
    fence_regs<NO>(acc);
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t)
      wgmma_rs<D>(acc, a[t], desc_mnmajor<D, kBK>(vt, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(acc);

    // the next tile's segment ids, then refill this stage
    if (kseg != nullptr && tid < kBK && kb + 1 < n_kb) {
      const int kpos = k0 + kBK + tid;
      kseg_s[((kb + 1) & 1) * kBK + tid] =
          kpos < sk ? kseg[(size_t)b * sk + kpos] : 0;
    }
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && kb + kStages < n_kb) {
      const int nk0 = (kb + kStages) * kBK;
      mbar_expect_tx(&full[st], 2 * L::tile);
      tma_load_tile<D, kBK>(k_s + st * L::tile, &kmap, &full[st], nk0, hk, b);
      tma_load_tile<D, kBK>(v_s + st * L::tile, &vmap, &full[st], nk0, hk, b);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qpos[rr] >= sq) continue;
    const float inv = l[rr] == 0.f ? 1.f : 1.f / l[rr];
    bf16* o_row = o + b * o_sb + qpos[rr] * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o_row + j * 8 + tq * 2) =
          pack_bf16(acc[4 * j + 2 * rr] * inv, acc[4 * j + 2 * rr + 1] * inv);
    if (tq == 0)
      lse[((size_t)b * sq + qpos[rr]) * hq + h] = row_lse(m[rr], l[rr]);
  }
}

// ---------------------------------------------------------------------
// bf16 at D 256, Sq > 64: two warpgroups share each K/V tile. At D 256 a
// K/V stage is 64 KB, so a one-warpgroup block's ring (Q and two stages,
// about 160 KB) leaves room for one block, one warpgroup, on an SM: its
// tensor cores sat idle through every softmax and every wait, and each 64
// q rows read every K/V tile. Here one block of 256 threads takes a
// 128-row q tile (q head, batch row): warpgroup w (threads 128w..128w+127)
// owns rows 64w..64w+63 and runs flash_fwd_wgmma's per-row loop on them
// (the same S product, online_softmax, P in registers, PV with V
// MN-major), so each row is computed in the same order and o and lse equal
// that kernel's bit for bit. Both warpgroups read the same K/V stage,
// which halves the K/V reads and the barrier waits per q row. Warpgroup 1
// issues its S product only once warpgroup 0's is done (named barrier 1),
// so the tensor cores run S of 0, S of 1, PV of 0, PV of 1: each
// warpgroup's softmax runs while the other's product keeps them busy
// (FlashAttention-3's ping-pong). Each warpgroup takes the causal bound
// and the masks over its own rows: it walks no tile its rows cannot see,
// and for a tile only the other reads it just keeps the barriers' count.
// Thread 0 loads Q and the first stages; once both warpgroups are done
// with a stage (named barrier 2), warpgroup 1's first thread refills it,
// off warpgroup 0's path to its next S product. Shared memory: Q 64 KB,
// two stages of 64 KB, segment ids. (A producer warp beside the two
// warpgroups would make 9 warps, 3 of them on one of the SM's four
// register files: ptxas then caps a thread at 168 registers, and O's 128
// accumulators spill.)
template <int D>
struct FwdPairSmem {  // byte offsets into the 1024-aligned shared memory
  static constexpr int tile = kBQ * D * 2;           // one [64][D] tile
  static constexpr int q = 0;                        // the 2 Q tiles
  static constexpr int k = 2 * tile;                 // kStages K tiles
  static constexpr int v = k + kStages * tile;       // kStages V tiles
  static constexpr int kseg = v + kStages * tile;    // [2][kBK] int
  static constexpr int bars = kseg + 2 * kBK * 4;    // Q, then K/V stages
  static constexpr int bytes = bars + (1 + kStages) * 8;
};
static_assert(FwdPairSmem<256>::bytes + kSmemSlack <= 232448,
              "K2's two-warpgroup shared memory");

// Warpgroup WG's rows of flash_fwd_wgmma_pair's q tile. WG is a template
// parameter, so no branch or descriptor below depends on the warpgroup at
// run time.
template <int D, int WG>
__device__ __forceinline__ void fwd_pair_rows(
    const CUtensorMap* kmap, const CUtensorMap* vmap, unsigned char* smem,
    bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ qseg, const int* __restrict__ kseg, int sq,
    int sk, int hq, int h, int hk, int b, int q0, int n0, int n1,
    long long o_sb, long long o_ss, long long o_sh, int causal,
    float scale_log2) {
  using L = FwdPairSmem<D>;
  constexpr int NO = D / 2;  // output accumulators per thread
  constexpr int KK = D / 16;
  constexpr int kPair = 2 * kWgThreads;  // threads of a named barrier
  const int tid = threadIdx.x, t = tid % kWgThreads;
  const int warp = t / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = sk - sq;
  const int r0 = q0 + WG * kBQ, my_n = WG == 0 ? n0 : n1;
  const int n_kb = max(n0, n1);
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  const unsigned char* qw = smem + L::q + WG * L::tile;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  // this thread's two rows: r0 + 16 warp + g and 8 below
  int qpos[2], qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qpos[rr] = r0 + warp * 16 + g + 8 * rr;
    qs[rr] = qseg != nullptr ? qseg[(size_t)b * sq + min(qpos[rr], sq - 1)]
                             : 0;
  }
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  float acc[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  if (my_n > 0) mbar_wait(qbar, 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages, k0 = kb * kBK;
    const unsigned char* kt = k_s + st * L::tile;
    const unsigned char* vt = v_s + st * L::tile;
    const bool active = kb < my_n;  // this warpgroup's rows see tile kb
    if (active) mbar_wait(&full[st], (kb / kStages) & 1);

    // S = Q K^T, warpgroup 0's first
    if (WG == 1) named_sync(1, kPair);
    if (active) {
      wgmma_fence();
      fence_regs<32>(s);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_ss<64>(s, desc_kmajor<D, kBQ>(qw, kk),
                     desc_kmajor<D, kBK>(kt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(s);
    }
    if (WG == 0) named_arrive(1, kPair);

    if (active) {
      // masks (only where this warpgroup's rows need them) and the online
      // softmax
      const int* ks = kseg_s + (kb & 1) * kBK;
      if (kseg != nullptr || k0 + kBK > sk ||
          (causal && k0 + kBK - 1 > r0 + offset))
        online_softmax<D, true>(s, acc, m, l, qpos, qs, ks, kseg, k0, sk,
                                causal, offset, tq, scale_log2);
      else
        online_softmax<D, false>(s, acc, m, l, qpos, qs, ks, kseg, k0, sk,
                                 causal, offset, tq, scale_log2);

      // O += P V: P from registers, V MN-major
      uint32_t a[4][4];
#pragma unroll
      for (int tt = 0; tt < kBK / 16; ++tt) wg_frag(a[tt], s, tt);
      wgmma_fence();
      fence_regs<NO>(acc);
#pragma unroll
      for (int tt = 0; tt < kBK / 16; ++tt)
        wgmma_rs<D>(acc, a[tt], desc_mnmajor<D, kBK>(vt, tt), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
    }

    // the next tile's segment ids, then refill this stage
    if (WG == 0 && kseg != nullptr && t < kBK && kb + 1 < n_kb) {
      const int kpos = k0 + kBK + t;
      kseg_s[((kb + 1) & 1) * kBK + t] =
          kpos < sk ? kseg[(size_t)b * sk + kpos] : 0;
    }
    named_sync(2, kPair);  // both warpgroups are done with stage st
    // warpgroup 1 refills: it issues its S product after 0's anyway
    if (WG == 1 && t == 0 && kb + kStages < n_kb) {
      const int nk0 = (kb + kStages) * kBK;
      mbar_expect_tx(&full[st], 2 * L::tile);
      tma_load_tile<D, kBK>(k_s + st * L::tile, kmap, &full[st], nk0, hk, b);
      tma_load_tile<D, kBK>(v_s + st * L::tile, vmap, &full[st], nk0, hk, b);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qpos[rr] >= sq) continue;
    const float inv = l[rr] == 0.f ? 1.f : 1.f / l[rr];
    bf16* o_row = o + b * o_sb + qpos[rr] * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o_row + j * 8 + tq * 2) =
          pack_bf16(acc[4 * j + 2 * rr] * inv, acc[4 * j + 2 * rr + 1] * inv);
    if (tq == 0)
      lse[((size_t)b * sq + qpos[rr]) * hq + h] = row_lse(m[rr], l[rr]);
  }
}

template <int D>
__global__ void
flash_fwd_wgmma_pair(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, int B, int sq, int sk,
                     int hq, int hkv, long long o_sb, long long o_ss,
                     long long o_sh, int causal, float scale_log2) {
  using L = FwdPairSmem<D>;
  const int n_qt = (sq + 2 * kBQ - 1) / (2 * kBQ);
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (hq * B));
  const int rest = blockIdx.x % (hq * B);
  const int h = rest % hq, b = rest / hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * 2 * kBQ, offset = sk - sq;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* q_s = smem + L::q;
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  // kv tiles the 64 rows from r0 read (none for rows past sq)
  auto tiles = [&](int r0) {
    if (r0 >= sq) return 0;
    int n = (sk + kBK - 1) / kBK;
    if (causal) n = min(n, (r0 + kBQ + offset + kBK - 1) / kBK);
    return max(n, 0);
  };
  const int n0 = tiles(q0), n1 = tiles(q0 + kBQ), n_kb = max(n0, n1);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    const bool two = n1 > 0;  // warpgroup 1 has rows before sq
    mbar_expect_tx(qbar, (two ? 2 : 1) * L::tile);
    tma_load_tile<D, kBQ>(q_s, &qmap, qbar, q0, h, b);
    if (two)
      tma_load_tile<D, kBQ>(q_s + L::tile, &qmap, qbar, q0 + kBQ, h, b);
    for (int s = 0; s < kStages && s < n_kb; ++s) {
      mbar_expect_tx(&full[s], 2 * L::tile);
      tma_load_tile<D, kBK>(k_s + s * L::tile, &kmap, &full[s], s * kBK, hk,
                            b);
      tma_load_tile<D, kBK>(v_s + s * L::tile, &vmap, &full[s], s * kBK, hk,
                            b);
    }
  }
  if (kseg != nullptr && tid < kBK)
    kseg_s[tid] = tid < sk ? kseg[(size_t)b * sk + tid] : 0;
  __syncthreads();  // barriers initialised, first segment ids staged

  if (tid < kWgThreads)
    fwd_pair_rows<D, 0>(&kmap, &vmap, smem, o, lse, qseg, kseg, sq, sk, hq,
                        h, hk, b, q0, n0, n1, o_sb, o_ss, o_sh, causal,
                        scale_log2);
  else
    fwd_pair_rows<D, 1>(&kmap, &vmap, smem, o, lse, qseg, kseg, sq, sk, hq,
                        h, hk, b, q0, n0, n1, o_sb, o_ss, o_sh, causal,
                        scale_log2);
}

// ---------------------------------------------------------------------
// Decode shapes (a few q rows over a long kv axis: the dense KV cache's
// one new token): split-KV, K1's flash-decoding design over contiguous,
// strided K/V. At Sq 1 the 64-row kernels above ran one block per q head
// (32 blocks for 132 SMs) on a q tile 63 rows of which were padding, each
// walking every kv tile in turn, and the q heads of a GQA group each read
// the same K/V rows. The work is bound by bytes: a K/V row of 2 D
// elements carries 2 rep D multiply-adds, one or two FLOPs a byte against
// the card's ~20 on its CUDA cores. So:
//   - one block of 4 warps per (split of the kv axis, kv head and group
//     of kDecRows rows, batch row); the rows are the group's rep q heads
//     times the Sq q rows (row g: q row g / rep, q head hk rep + g % rep),
//     so every K/V row is read once per group; the wrapper sizes the
//     splits (decode_plan) so the grid covers the SMs;
//   - a block stages its split kDecChunk rows at a time, K and V by
//     16-byte cp.async (4-byte for a float32 view off 16-byte alignment)
//     into two stages, the next chunk in flight during this one's math;
//     rows past the split's end are zero-filled, never read;
//   - CUDA-core FMAs in float32 for both types: warp w owns rows w, w + 4,
//     w + 8, w + 12, one row at a time, and lane c a chunk's kv row c for
//     S = q k^T (K rows padded by 16 bytes: conflict-free 16-byte reads;
//     four partial sums a score), the online softmax in base 2 over the
//     warp's lanes, then lane c owns head dims c + 32 j for O += P V over
//     the chunk's rows (a zero-filled row has p = 0), p read 4 at a time
//     from the warp's slot in shared memory (rounded to the kv type first
//     in bf16, as _fwd_kernel rounds it). Each step is straight-line code
//     inside a warp-uniform branch, so that one kv row's loads overlap
//     another's products;
//   - each split writes its (m, l, acc) in float32; the last split of a
//     (batch row, kv head, row group) to finish, found by an atomic count
//     that it leaves at zero again, merges the splits by their
//     log-sum-exp into o (q's type) and lse. A single split writes o and
//     lse itself: one launch, where a merge kernel would add a second.
// At the dense cache's decode the block is bound by the latency of its
// steps, not by its bytes: one wave of blocks, one chunk each.
// The masks are the 64-row kernels': columns past the split's live end
// (sk, or the causal bound of the block's last q row) are masked; the
// causal bound per row and segment equality only on a chunk that needs
// them. A row that sees no kv gives o = 0 and lse = -1e30.
constexpr int kDecThreads = 128;
constexpr int kDecRows = 16;   // rows of a block (decode_plan's DECODE_ROWS)
constexpr int kDecChunk = 32;  // kv rows a stage holds (DECODE_CHUNK)
constexpr int kDecWarpRows = kDecRows / (kDecThreads / 32);

template <typename T, int D>
struct DecSmem {                                   // byte offsets
  static constexpr int RS = D + 16 / sizeof(T);    // a K/V row's stride
  static constexpr int chunk = kDecChunk * RS * sizeof(T);  // a K or V chunk
  static constexpr int q = 0;                      // [kDecRows][D] float
  static constexpr int kv = kDecRows * D * 4;      // [2 stages][K, V]
  static constexpr int kseg = kv + 4 * chunk;      // [2 stages][kDecChunk]
  static constexpr int p = kseg + 2 * kDecChunk * 4;  // [warps][kDecChunk]
  static constexpr int bytes = p + kDecThreads * 4;
};
static_assert(DecSmem<float, 256>::bytes <= 232448, "K2 decode smem");

// One row's splits merged by their log-sum-exp (base 2) by one warp, lane
// c holding head dims c + 32 j: the lanes read 32 splits' (m, l) at once
// and pass each split's weight by a shuffle, so that the loads of the
// splits' acc rows do not wait on one another. The partials were written
// by other blocks of this launch: read through L2 (ld.global.cg).
template <typename T, int D>
__device__ __forceinline__ void merge_splits(const float* part_acc,
                                             const float* part_ml, size_t rows,
                                             size_t row, int n_split,
                                             int lane, T* o_row, float* lse) {
  constexpr int DJ = (D + 31) / 32;
  auto load_ml = [&](int i) {  // split i's (m, l); (-1e30, 0) past the last
    return i < n_split ? __ldcg(reinterpret_cast<const float2*>(
                             part_ml + (i * rows + row) * 2))
                       : make_float2(NEG_INF_F, 0.f);
  };
  const float2 ml0 = load_ml(lane);  // the first 32 splits, kept
  float mx = ml0.x;
  for (int i = lane + 32; i < n_split; i += 32) mx = fmaxf(mx, load_ml(i).x);
  mx = group_max<32>(mx);
  float sum = 0.f, acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.f;
  for (int base = 0; base < n_split; base += 32) {
    const int n = min(32, n_split - base);
    // split base + lane's weight (a split that saw no kv has l = 0)
    const float2 ml = base == 0 ? ml0 : load_ml(base + lane);
    const float w = exp2f(ml.x - mx);
    sum = fmaf(ml.y, w, sum);
#pragma unroll 16
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* pa = part_acc + ((base + j) * rows + row) * D;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        if (lane + 32 * jj < D)
          acc[jj] = fmaf(__ldcg(pa + lane + 32 * jj), wj, acc[jj]);
    }
  }
  sum = group_sum<32>(sum);
  const float inv = sum == 0.f ? 0.f : 1.f / sum;
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj)
    if (lane + 32 * jj < D) o_row[lane + 32 * jj] = from_f32<T>(acc[jj] * inv);
  if (lane == 0) *lse = row_lse(mx, sum);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_fwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ qseg,
                        const int* __restrict__ kseg, float* part_acc,
                        float* part_ml, int* counts, int sq, int sk, int hq,
                        int hkv, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long o_sb, long long o_ss,
                        long long o_sh, int causal, float scale_log2,
                        int split_rows, int vec16) {
  using L = DecSmem<T, D>;
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int DJ = (D + 31) / 32;   // head dims of a lane in O += P V
  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.z;
  const int rep = hq / hkv, n_all = rep * sq;
  const int groups = (n_all + kDecRows - 1) / kDecRows;
  const int hk = blockIdx.y / groups, r0 = blockIdx.y % groups * kDecRows;
  const int n_rows = min(kDecRows, n_all - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int offset = sk - sq;

  // this block's kv rows [kb, ke): the split, cut at sk and at the causal
  // bound of its last q row (no row sees past it)
  const int kb = split * split_rows;
  int ke = min(sk, kb + split_rows);
  const int s_first = r0 / rep, s_last = (r0 + n_rows - 1) / rep;
  if (causal) ke = min(ke, s_last + offset + 1);
  const int n_chunks = ke > kb ? (ke - kb + kDecChunk - 1) / kDecChunk : 0;

  extern __shared__ __align__(16) unsigned char dsmem[];
  float* q_s = reinterpret_cast<float*>(dsmem + L::q);
  int* kseg_s = reinterpret_cast<int*>(dsmem + L::kseg);
  float* p_s = reinterpret_cast<float*>(dsmem + L::p);
  const T* k_base = k + b * k_sb + hk * k_sh;
  const T* v_base = v + b * v_sb + hk * v_sh;

  // chunk c of the split into stage st, as one commit group
  auto load_chunk = [&](int c, int st) {
    const int c0 = kb + c * kDecChunk, n = min(kDecChunk, ke - c0);
    T* ks = reinterpret_cast<T*>(dsmem + L::kv + 2 * st * L::chunk);
    T* vs = reinterpret_cast<T*>(dsmem + L::kv + (2 * st + 1) * L::chunk);
    if (vec16) {
      for (int i = tid; i < kDecChunk * (D / VE); i += kDecThreads) {
        const int r = i / (D / VE), e = i % (D / VE) * VE;
        const long long row = c0 + min(r, n - 1);  // in bounds, read or not
        const int bytes = r < n ? 16 : 0;
        cp_async<16>(ks + r * L::RS + e, k_base + row * k_ss + e, bytes);
        cp_async<16>(vs + r * L::RS + e, v_base + row * v_ss + e, bytes);
      }
    } else if constexpr (sizeof(T) == 4) {  // a float32 view off alignment
      for (int i = tid; i < kDecChunk * D; i += kDecThreads) {
        const int r = i / D, e = i % D;
        const long long row = c0 + min(r, n - 1);
        const int bytes = r < n ? 4 : 0;
        cp_async<4>(ks + r * L::RS + e, k_base + row * k_ss + e, bytes);
        cp_async<4>(vs + r * L::RS + e, v_base + row * v_ss + e, bytes);
      }
    }
    if (kseg != nullptr && tid < kDecChunk)
      kseg_s[st * kDecChunk + tid] =
          tid < n ? kseg[(size_t)b * sk + c0 + tid] : 0;
    cp_async_commit();
  };
  if (n_chunks > 0) load_chunk(0, 0);
  if (n_chunks > 1) load_chunk(1, 1);

  // the block's q rows as float32, every load in flight at once (a loop
  // that stored each value before loading the next waited out one global
  // load latency per value)
  constexpr int QPT = kDecRows * D / kDecThreads;
  float qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * kDecThreads, r = i / D, e = i % D, g = r0 + r;
    qv[u] = r < n_rows ? to_f32(q[b * q_sb + (g / rep) * q_ss +
                                  (hk * rep + g % rep) * q_sh + e])
                       : 0.f;
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) q_s[tid + u * kDecThreads] = qv[u];
  // this warp's rows w + 4i: q row, segment id, running (m, l, acc)
  int spos[kDecWarpRows], qs[kDecWarpRows];
  float m[kDecWarpRows], l[kDecWarpRows], acc[kDecWarpRows][DJ];
#pragma unroll
  for (int i = 0; i < kDecWarpRows; ++i) {
    const int g = r0 + min(warp + 4 * i, n_rows - 1);
    spos[i] = g / rep;
    qs[i] = qseg != nullptr ? qseg[(size_t)b * sq + spos[i]] : 0;
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, c0 = kb + c * kDecChunk;
    if (c + 1 < n_chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk c (and q_s) visible to every thread
    const T* ks =
        reinterpret_cast<const T*>(dsmem + L::kv + 2 * st * L::chunk);
    const T* vs =
        reinterpret_cast<const T*>(dsmem + L::kv + (2 * st + 1) * L::chunk);
    const bool mask = kseg != nullptr || c0 + kDecChunk > ke ||
                      (causal && c0 + kDecChunk - 1 > s_first + offset);

    // row by row of the warp's rows: a warp-uniform branch around
    // straight-line code
    const T* k_row = ks + lane * L::RS;
    float* p_w = p_s + warp * kDecChunk;
#pragma unroll
    for (int i = 0; i < kDecWarpRows; ++i) {
      if (warp + 4 * i >= n_rows) break;  // warp-uniform
      // S: lane = kv row c0 + lane; four partial sums
      const float* q_row = q_s + (warp + 4 * i) * D;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < D; e += VE) {
        float kf[VE];
        if constexpr (sizeof(T) == 4) {
          const float4 x = *reinterpret_cast<const float4*>(k_row + e);
          kf[0] = x.x; kf[1] = x.y; kf[2] = x.z; kf[3] = x.w;
        } else {
          const uint4 x = *reinterpret_cast<const uint4*>(k_row + e);
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
          for (int u = 0; u < VE / 2; ++u) {
            const float2 f = __bfloat1622float2(h2[u]);
            kf[2 * u] = f.x;
            kf[2 * u + 1] = f.y;
          }
        }
#pragma unroll
        for (int u = 0; u < VE; u += 4) {
          const float4 qf = *reinterpret_cast<const float4*>(q_row + e + u);
          sc[0] = fmaf(qf.x, kf[u], sc[0]);
          sc[1] = fmaf(qf.y, kf[u + 1], sc[1]);
          sc[2] = fmaf(qf.z, kf[u + 2], sc[2]);
          sc[3] = fmaf(qf.w, kf[u + 3], sc[3]);
        }
      }

      // the online softmax over the warp's lanes
      float x = ((sc[0] + sc[1]) + (sc[2] + sc[3])) * scale_log2;
      bool keep = true;
      if (mask) {
        const int kpos = c0 + lane;
        keep = kpos < ke;
        if (causal) keep = keep && kpos <= spos[i] + offset;
        if (kseg != nullptr)
          keep = keep && kseg_s[st * kDecChunk + lane] == qs[i];
        if (!keep) x = NEG_INF_F;
      }
      const float m_new = fmaxf(m[i], group_max<32>(x));
      const float pr = keep ? exp2f(x - m_new) : 0.f;
      const float alpha = exp2f(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum<32>(pr);
      m[i] = m_new;
      p_w[lane] = to_f32(from_f32<T>(pr));  // rounded to the kv type
      __syncwarp();

      // O += P V over every row of the chunk (a row past the split's live
      // end was zero-filled and has p = 0); p read 4 at a time
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
      // kv rows a straight-line step: fewer at D 256, where a lane holds
      // 8 head dims of each row (registers)
      constexpr int JB = D > 128 ? 8 : kDecChunk;
#pragma unroll 1
      for (int j0 = 0; j0 < kDecChunk; j0 += JB) {
#pragma unroll
        for (int j = j0; j < j0 + JB; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_w + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const T* v_row = vs + (j + u) * L::RS;
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj)
              if (lane + 32 * jj < D)
                acc[i][jj] = fmaf(pj[u], to_f32(v_row[lane + 32 * jj]),
                                  acc[i][jj]);
          }
        }
      }
      __syncwarp();  // p_w is read before the next row writes it
    }
    __syncthreads();  // every warp is done with stage st
    if (c + 2 < n_chunks) load_chunk(c + 2, st);
  }

  // one split: o and lse; else this split's (m, l, acc) for the merge
  const size_t rows_all = (size_t)gridDim.z * sq * hq;
#pragma unroll
  for (int i = 0; i < kDecWarpRows; ++i) {
    if (warp + 4 * i >= n_rows) continue;
    const int g = r0 + warp + 4 * i, s = g / rep, h = hk * rep + g % rep;
    const size_t row = ((size_t)b * sq + s) * hq + h;
    if (n_split == 1) {
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
      T* o_row = o + b * o_sb + s * o_ss + h * o_sh;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        if (lane + 32 * jj < D)
          o_row[lane + 32 * jj] = from_f32<T>(acc[i][jj] * inv);
      if (lane == 0) lse[row] = row_lse(m[i], l[i]);
    } else {
      const size_t idx = split * rows_all + row;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        if (lane + 32 * jj < D)
          part_acc[idx * D + lane + 32 * jj] = acc[i][jj];
      if (lane == 0) {
        part_ml[idx * 2] = m[i];
        part_ml[idx * 2 + 1] = l[i];
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (batch row, kv head, row group) merges
  __shared__ int last;
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  int* count = counts + (size_t)b * gridDim.y + blockIdx.y;
  if (tid == 0) last = atomicAdd(count, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < kDecWarpRows; ++i) {
    if (warp + 4 * i >= n_rows) continue;
    const int g = r0 + warp + 4 * i, s = g / rep, h = hk * rep + g % rep;
    const size_t row = ((size_t)b * sq + s) * hq + h;
    merge_splits<T, D>(part_acc, part_ml, rows_all, row, n_split, lane,
                       o + b * o_sb + s * o_ss + h * o_sh, lse + row);
  }
  if (tid == 0) *count = 0;  // for the next launch
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* qseg, const void* kseg,
                  void* part_acc, void* part_ml, void* counts, int B, int sq,
                  int sk, int hq, int hkv, const long long* st, int causal,
                  float scale, int split_rows, int n_split,
                  cudaStream_t stream) {
  using L = DecSmem<T, D>;
  const int groups = (hq / hkv * sq + kDecRows - 1) / kDecRows;
  const bool vec16 = rows_16b(k, sizeof(T), st[3], st[4], st[5]) &&
                     rows_16b(v, sizeof(T), st[6], st[7], st[8]);
  if (!vec16 && sizeof(T) != 4) return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr ||
                      counts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_fwd_decode_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  const dim3 grid(n_split, hkv * groups, B);
  flash_fwd_decode_kernel<T, D><<<grid, kDecThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counts), sq, sk, hq, hkv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale * kLog2e, split_rows, (int)vec16);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, const void* qseg, const void* kseg, int B, int sq,
                 int sk, int hq, int hkv, const long long* st, int causal,
                 float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, sq, hq, D, st[0], st[1], st[2], kBQ);
  if (err == 0) err = make_map(&km, k, B, sk, hkv, D, st[3], st[4], st[5], kBK);
  if (err == 0) err = make_map(&vm, v, B, sk, hkv, D, st[6], st[7], st[8], kBK);
  if (err != 0) return err;
  // D 256 past one q tile: the two-warpgroup kernel. At Sq <= 64 (the
  // dense cache's decode at Sq 1, speculative verify's 64 rows) a 128-row
  // tile would be half padding, so the one-warpgroup kernel stays.
  if constexpr (D == 256) {
    if (sq > kBQ) {
      const int smem = FwdPairSmem<D>::bytes + kSmemSlack;
      cudaFuncSetAttribute(flash_fwd_wgmma_pair<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      const int blocks = (sq + 2 * kBQ - 1) / (2 * kBQ) * hq * B;
      flash_fwd_wgmma_pair<D><<<blocks, 2 * kWgThreads, smem, stream>>>(
          qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse),
          static_cast<const int*>(qseg), static_cast<const int*>(kseg), B, sq,
          sk, hq, hkv, st[9], st[10], st[11], causal, scale * kLog2e);
      return (int)cudaGetLastError();
    }
  }
  const int smem = FwdSmem<D>::bytes + kSmemSlack;
  cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = (sq + kBQ - 1) / kBQ * hq * B;
  flash_fwd_wgmma<D><<<blocks, kWgThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), B, sq, sk,
      hq, hkv, st[9], st[10], st[11], causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* qseg, const void* kseg, int B, int sq,
               int sk, int hq, int hkv, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  using L = FwdF32<D>;
  cudaFuncSetAttribute(flash_fwd_f32<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::bytes);
  const bool vec16 = rows_16b(q, 4, st[0], st[1], st[2]) &&
                     rows_16b(k, 4, st[3], st[4], st[5]) &&
                     rows_16b(v, 4, st[6], st[7], st[8]);
  const int blocks = (sq + kBQ - 1) / kBQ * hq * B;
  flash_fwd_f32<D><<<blocks, L::NT, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), B, sq, sk, hq, hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      scale, (int)vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o.
// Head dims: HEAD_DIM_CASES (common.cuh; the wrapper refuses others). At
// D 256 a bf16 thread holds 128 O accumulators beside S's 32, in either
// design: one warpgroup per 64 q rows up to Sq 64, two warpgroups sharing
// each K/V tile of 128 q rows past it.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, void* lse, const void* qseg,
                         const void* kseg, int B, int sq, int sk, int hq,
                         int hkv, int d, const long long* strides, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGMMA(D)                                                          \
  launch_wgmma<D>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, \
                  causal, scale, s)
#define F32(D)                                                           \
  launch_f32<D>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, \
                causal, scale, s)
  if (dtype == DTYPE_BF16) {
    switch (d) {
      HEAD_DIM_CASES(WGMMA)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == DTYPE_F32) {
    switch (d) {
      HEAD_DIM_CASES(F32)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef WGMMA
#undef F32
  return (int)cudaErrorInvalidValue;
}

// The split-KV kernel for decode shapes: flash_fwd's arguments, then the
// float32 partial buffers part_acc [n_split, B, Sq, Hq, D] and part_ml
// [n_split, B, Sq, Hq, 2] and the int32 counts [B, Hkv x row groups],
// zero before the launch and left at zero by it (all unused when n_split
// is 1), and the split of split_rows kv rows (decode_plan in the wrapper).
extern "C" int flash_fwd_decode(int dtype, const void* q, const void* k,
                                const void* v, void* o, void* lse,
                                const void* qseg, const void* kseg,
                                void* part_acc, void* part_ml, void* counts,
                                int B, int sq,
                                int sk, int hq, int hkv, int d,
                                const long long* strides, int causal,
                                float scale, int split_rows, int n_split,
                                void* stream) {
  if (split_rows <= 0 || n_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEC(T, D)                                                        \
  launch_decode<T, D>(q, k, v, o, lse, qseg, kseg, part_acc, part_ml,    \
                      counts, B, sq, sk, hq, hkv, strides, causal, scale, \
                      split_rows, n_split, s)
#define DEC_BF16(D) DEC(bf16, D)
#define DEC_F32(D) DEC(float, D)
  if (dtype == DTYPE_BF16) {
    switch (d) {
      HEAD_DIM_CASES(DEC_BF16)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == DTYPE_F32) {
    switch (d) {
      HEAD_DIM_CASES(DEC_F32)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef DEC
#undef DEC_BF16
#undef DEC_F32
  return (int)cudaErrorInvalidValue;
}
