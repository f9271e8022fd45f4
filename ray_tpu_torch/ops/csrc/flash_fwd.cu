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
// What bounds it on the H100: operations. Prefill attention does
// 4*D*Sq*Sk/2 (causal) operations on O((Sq+Sk)*D) bytes, hundreds of
// operations per byte, so the card's arithmetic is the roofline. Two
// variants, chosen by the input type:
//   - bf16 (serving and training) is built for Hopper: wgmma on operands
//     in shared memory, filled by TMA through an mbarrier ring, with P
//     kept in registers between the two products and V read MN-major
//     through the descriptor. One warpgroup per 64-row q tile
//     (flash_fwd_wgmma) at every head dim, except at D 256 past 64 q
//     rows: there two warpgroups share each K/V tile of a 128-row q tile
//     and take turns at the tensor cores (flash_fwd_wgmma_pair);
//   - float32 (the exact reference path of the tests) keeps scalar FMAs
//     on float32 tiles: one block per (64-row q tile, q head, batch row)
//     of 256 threads, each owning a 4x4 patch of the score tile.
// All loop over 64-row kv tiles, and the causal bound ends the loop
// early. Head dims 16, 32, 64, 96, 128 and 256, each its own instance of
// both variants (the bf16 tiles' layout for each is hopper.cuh's).
// Not done yet: the two-warpgroup design at the other head dims (where a
// one-warpgroup block leaves room for a second block on the SM), a TMA
// producer warp with setmaxnreg, and overlapping one tile's softmax with
// the same warpgroup's next S product; a TMA store of o; reading ctx pages
// through the block table instead of a gathered copy.
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // kv rows per iteration
constexpr int kThreads = 256;  // 16 x 16 thread grid

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, int sq, int sk, int hq,
                 int hkv, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh, int causal,
                 float scale) {
  constexpr int DS = D + 1;    // padded smem row stride (floats)
  constexpr int PS = kBK + 1;  // padded probability row stride
  constexpr int DC = D / 16;   // output columns per thread

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kBQ;
  const int offset = sk - sq;

  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][DS]
  float* k_s = q_s + kBQ * DS;     // [kBK][DS]
  float* v_s = k_s + kBK * DS;     // [kBK][DS]
  float* p_s = v_s + kBK * DS;     // [kBQ][PS]

  const T* q_base = q + b * q_sb + h * q_sh;
  const T* k_base = k + b * k_sb + hk * k_sh;
  const T* v_base = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    const int qpos = q0 + r;
    q_s[r * DS + e] = qpos < sq ? to_f32(q_base[qpos * q_ss + e]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
  int qs[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF_F;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
    const int qpos = min(q0 + ty + 16 * a, sq - 1);
    qs[a] = qseg != nullptr ? qseg[(size_t)b * sq + qpos] : 0;
  }

  int n_kb = (sk + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (q0 + kBQ + offset + kBK - 1) / kBK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous iteration is done with k_s, v_s, p_s
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, e = i - r * D;
      const int kpos = k0 + r;
      const bool in = kpos < sk;
      k_s[r * DS + e] = in ? to_f32(k_base[kpos * k_ss + e]) : 0.f;
      v_s[r * DS + e] = in ? to_f32(v_base[kpos * v_ss + e]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16a, cols tx + 16c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * DS + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = k_s[(tx + 16 * c) * DS + e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

    // masks, online softmax; a row's 16 owners are one half-warp
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a;
      bool ok[4];
      float mx = NEG_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos + offset;
        if (kseg != nullptr && keep) keep = kseg[(size_t)b * sk + kpos] == qs[a];
        ok[c] = keep;
        s[a][c] = keep ? s[a][c] * scale : NEG_INF_F;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        p_s[(ty + 16 * a) * PS + tx + 16 * c] = p;
        sum += p;
      }
      sum = group_sum<16>(sum);
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16a, cols tx + 16c
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = v_s[j * DS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q0 + ty + 16 * a;
    if (qpos >= sq) continue;
    const float l_safe = l[a] == 0.f ? 1.f : l[a];
    T* o_row = o + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o_row[tx + 16 * c] = from_f32<T>(acc[a][c] / l_safe);
    if (tx == 0) lse[((size_t)b * sq + qpos) * hq + h] = m[a] + logf(l_safe);
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

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages, k0 = kb * kBK;
    const unsigned char* kt = k_s + st * L::tile;
    const unsigned char* vt = v_s + st * L::tile;
    mbar_wait(&full[st], (kb / kStages) & 1);

    // S = Q K^T
    wgmma_fence();
    fence_regs<32>(s);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(s, desc_kmajor<D, kBQ>(q_s, kk),
                   desc_kmajor<D, kBK>(kt, kk), kk > 0);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* qseg, const void* kseg, int B, int sq, int sk, int hq,
           int hkv, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
  cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((sq + kBQ - 1) / kBQ, hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), sq, sk,
      hq, hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale);
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
#define SCALAR(D)                                                         \
  launch<float, D>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, \
                   causal, scale, s)
  if (dtype == DTYPE_BF16) {
    switch (d) {
      HEAD_DIM_CASES(WGMMA)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == DTYPE_F32) {
    switch (d) {
      HEAD_DIM_CASES(SCALAR)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef WGMMA
#undef SCALAR
  return (int)cudaErrorInvalidValue;
}
