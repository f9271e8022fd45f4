// K3 and K4: the flash-attention backward, dq and dk/dv, from the saved
// log-sum-exp (FlashAttention-2's recompute of p).
//
// Replace the TPU kernels ray_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (K3, pl.pallas_call in _bwd, "dq") and ::_bwd_dkv_kernel (K4, "dk/dv").
// Public layout, read through strides like K2 (flash_fwd.cu):
//   q, do [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] (last dim contiguous; in
//   training v is a strided view of the fused QKV output),
//   lse, delta [B, Sq, Hq] float32 contiguous (lse from K2, delta =
//   rowsum(do * o)),
//   dq [B, Sq, Hq, D] in q's type, dk/dv [B, Sk, Hkv, D] in k's type, all
//   three contiguous.
// With s = scale * q.k, every live (q, k) pair has
//   p = exp(s - lse), dp = do.v, ds = p * (dp - delta) * scale,
//   dq = sum_k ds k,  dk = sum_q ds q,  dv = sum_q p do.
// The masks are K2's: k_pos < sk, causal k_pos <= q_pos + sk - sq, and the
// optional q_seg == kv_seg. p is zeroed for a masked pair AFTER the exp is
// skipped: a fully masked row has lse = -1e30, and exp(-1e30 - lse) would
// be 1. Rows at or past Sq / Sk are zero-filled, never loaded, and masked.
//
// What bounds it on the H100: operations. K3 does 3 and K4 4 products of
// 2*D FLOPs per live (q, k) pair over O((Sq + Sk) * D) bytes.
//   - K3: one block per (64-row q tile, q head, batch row), looping over
//     64-row kv tiles up to the causal limit; dq stays in registers.
//   - K4: one block per (64-row kv tile, KV head, batch row). It loops
//     over the Hq / Hkv q heads of its group and, for each, over the q
//     tiles from the causal start, so dk and dv accumulate for the whole
//     GQA group in float32 registers: the TPU version's per-q-head f32
//     partials [B, Hq, Sk, D] and their group sum never touch HBM.
// Head dims 16, 32, 64, 96, 128 and 256, each its own instance of both
// variants; at D 256 the float32 variants take 32-row tiles of their own
// rows (shared memory), and the bf16 K4 is a block of two warpgroups, one
// computing S^T and the other dP^T, each owning half of dK's and dV's
// columns (registers), and so is the bf16 K3, one warpgroup computing S
// and the other dP, each owning half of dQ's columns (bwd_dq_wgmma_pair);
// at D 96 the bf16 K4 is a block of two warpgroups over a 128-row kv
// tile, each owning 64 of its rows (bwd_dkv_wgmma_rows): see each kernel.
// Two variants each, chosen by the input type, as in K2: an exact
// scalar-FMA float32 variant (register tiles read as 16-byte shared loads,
// their operands copied in flight by cp.async: see bwd_dq_f32 and
// bwd_dkv_f32) and, in bf16, a variant built for Hopper: wgmma with TMA
// through an mbarrier ring, p and ds rounded to bf16 in registers as the
// A operand of the next product, and every transposed operand read
// MN-major through the descriptor, so no tile is copied transposed (see
// bwd_dkv_wgmma, bwd_dkv_wgmma_pair, bwd_dkv_wgmma_rows, bwd_dq_wgmma and
// bwd_dq_wgmma_pair).
// Not done yet: K3 at D 96 redesigned; bwd_dkv_wgmma_rows' design
// at the other head dims (chip_variants.py probes it at D 64 and 128); one
// fused kernel writing dq by atomics (FlashAttention-2's layout) instead
// of two passes; two K3 float32 blocks an SM at D 96 and 128 (their tiles
// take 145,920 and 186,880 bytes of shared memory).
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;       // q rows per tile
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 256;  // scalar variant: a 16 x 16 thread grid

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Sq, Hq]
  const float* delta;  // [B, Sq, Hq]
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Sk] or null
  void* dq;            // [B, Sq, Hq, D]
  void* dk;            // [B, Sk, Hkv, D]
  void* dv;            // [B, Sk, Hkv, D]
  int sq, sk, hq, hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;  // o_*: strides of do
  int causal;
  float scale;
  int vec16;  // q, k, v, do rows copy in 16-byte pieces (float32 K3, K4)
};

// number of kv tiles a q tile of `rows` rows starting at q0 reads (K2's
// causal bound)
__device__ __forceinline__ int kv_tiles(const BwdParams& p, int q0,
                                        int rows = kBQ) {
  int n = (p.sk + kBK - 1) / kBK;
  if (p.causal) n = min(n, (q0 + rows + (p.sk - p.sq) + kBK - 1) / kBK);
  return n;
}

// first q tile whose rows can see a kv tile starting at k0
__device__ __forceinline__ int first_q_tile(const BwdParams& p, int k0) {
  return p.causal ? max(k0 - (p.sk - p.sq), 0) / kBQ : 0;
}

__device__ __forceinline__ bool live(const BwdParams& p, int qpos, int kpos,
                                     int qs, int ks) {
  bool keep = qpos < p.sq && kpos < p.sk;
  if (p.causal) keep = keep && kpos <= qpos + (p.sk - p.sq);
  if (p.kseg != nullptr) keep = keep && qs == ks;
  return keep;
}

__device__ __forceinline__ size_t row_index(const BwdParams& p, int b,
                                            int qpos, int h) {
  return ((size_t)b * p.sq + qpos) * p.hq + h;  // into lse / delta
}

// ---------------------------------------------------------------------
// float32 variants: exact scalar FMAs on float32 tiles, a block's threads
// as a (threads / 16) x 16 grid (ty, tx).
//
// K3 (bwd_dq_f32, one block per (q tile, q head, batch row), heaviest q
// tiles first) is bound by how fast it can feed its FMAs: per live pair
// it does 3 D FMAs on operands in shared memory. Its design:
//   - register tiles read as 16-byte shared loads: thread (ty, tx) owns
//     rows ty + TY i (TY = threads / 16) and kv columns tx + 16 j (j < 4)
//     of S and dP, and walks the head dim 4 columns at a time, reading a
//     row's 4 values of q, do, k and v as one float4 each (rows padded by
//     4 floats: the 8 k rows a quarter-warp reads fall in distinct banks,
//     its q row is one broadcast): with 4 rows a thread, 16 loads for 128
//     FMAs. For dQ += dS K it owns rows ty + TY i and head dims
//     VW tx + 16 VW n + w (float4, float2 or scalar pieces of a k row),
//     and reads 4 dS columns of a row as one float4: at D 96, 16 loads
//     for 96 FMAs;
//   - 256 threads (4 rows each of a 64-row q tile) up to D 128; 128 at D
//     256 (4 rows each of a 32-row tile), where 256 threads would hold two
//     rows each: half the FMAs a load, and slower on the card;
//   - copies in flight: q and do once, K and V by 16-byte cp.async (4-byte
//     for a view off 16-byte alignment); K in two stages (the next tile
//     lands during this one's three products), V in one, refilled as soon
//     as dP is done, during dS and dQ (one stage of K at D 256, where two
//     do not fit);
//   - shared memory: 104,960 bytes at D 64 and less below, so two blocks
//     share an SM there (__launch_bounds__ then holds a thread to 128
//     registers); 145,920 at D 96, 186,880 at D 128 and 208,640 at D 256
//     (32-row q tiles), one block;
//   - masks only on a tile that crosses the causal limit or the sk edge,
//     or that carries segment ids, whose kv ids are staged with the K tile
//     (the warp that writes a row of dS also reads it: __syncwarp, no
//     block barrier, between the two).
// K4 (bwd_dkv_f32, one block per (kv tile, kv head, batch row), heaviest
// kv tiles first) is K3's design transposed, bound the same way (4 D FMAs
// per live pair):
//   - thread (ty, tx) owns kv rows ty + TY i and q columns tx + 16 j of
//     S^T and dP^T, reading its rows of k and v (each one broadcast) and
//     its columns' rows of q and dO 4 head dims at a time as float4s: with
//     4 rows a thread, 16 loads for 128 FMAs. P^T, then dS^T in its place,
//     go through the rows' block of shared memory, which only the same
//     warp reads back; dV += P^T dO and dK += dS^T Q own rows ty + TY i
//     and head dims VW tx + 16 VW n + w, as K3's dQ;
//   - kv tiles of f32_rows<D>() rows (32 at D 256), 256 threads, 4 rows a
//     thread; dK and dV stay in float32 registers for the whole GQA group.
//     At D 256 the block is two halves of 128 threads: half 0 computes S^T
//     and P^T, half 1 dP^T and, from the P^T that half 0 wrote, dS^T; each
//     half owns 128 of dK's and dV's head dims (one thread holding all 256
//     took 255 registers and spilled);
//   - copies in flight: K and V once; the (q head, q tile) items stream
//     their q and dO rows, lse, delta and q segment ids by cp.async, item
//     it + 1 landing during item it in two stages (one block barrier an
//     item), or refilled after the item in one stage (D 64 and 256);
//   - shared memory: 87,808 bytes at D 64 (one stage), so two blocks
//     share an SM there (a few bytes spill at 128 registers); 49,664 at D
//     16, 74,240 at D 32, 172,544 at D 96, 221,696 at D 128 and 217,856
//     at D 256 (P^T and dS^T in two buffers), one block;
//   - masks only on an item that crosses the causal limit, the sk or sq
//     edge, or that carries segment ids.

template <int D>
__host__ __device__ constexpr int f32_rows() {
  return D > 128 ? 32 : 64;
}

// K3's float32 tiles: offsets in floats into shared memory
template <int D>
struct DqF32 {
  // threads, (NT / 16) x 16: 128 at D 256, where a 32-row q tile gives
  // 256 threads only two rows each
  static constexpr int NT = D > 128 ? 128 : kThreads;
  static constexpr int TY = NT / 16;
  static constexpr int BQ = f32_rows<D>();     // q rows of a block
  static constexpr int A = BQ / TY;            // rows of a thread
  static constexpr int RS = D + 4;             // padded row stride
  static constexpr int PS = kBK + 4;           // dS row stride
  static constexpr int KSTAGES = D > 128 ? 1 : 2;
  static constexpr int DC = D / 16;            // dQ head dims of a thread
  static constexpr int VW = DC % 4 == 0 ? 4 : DC % 2 == 0 ? 2 : 1;
  static constexpr int q = 0;                  // [BQ][RS]
  static constexpr int dout = q + BQ * RS;     // [BQ][RS]
  static constexpr int k = dout + BQ * RS;     // [KSTAGES][kBK][RS]
  static constexpr int v = k + KSTAGES * kBK * RS;  // [kBK][RS]
  static constexpr int ds = v + kBK * RS;      // [BQ][PS]
  static constexpr int kseg = ds + BQ * PS;    // [KSTAGES][kBK] int
  static constexpr size_t bytes = 4 * (size_t)(kseg + KSTAGES * kBK);
  static constexpr int min_blocks = 2 * bytes + 2048 <= 233472 ? 2 : 1;
};
static_assert(DqF32<64>::min_blocks == 2 && DqF32<96>::min_blocks == 1,
              "K3 f32 blocks an SM");
static_assert(DqF32<256>::bytes <= 232448, "K3 f32 shared memory");

// K4's float32 tiles: offsets in floats into shared memory
template <int D>
struct DkvF32 {
  // at D 256 the block is two halves of 128 threads: one computes S^T,
  // the other dP^T, and each owns half of dK's and dV's head dims (a
  // thread holding all of them took 255 registers)
  static constexpr bool PAIR = D > 128;
  static constexpr int NT = kThreads;          // TY x 16 (in each half)
  static constexpr int TY = (PAIR ? NT / 2 : NT) / 16;
  static constexpr int BK = f32_rows<D>();     // kv rows of a block
  static constexpr int A = BK / TY;            // rows of a thread
  static constexpr int RS = D + 4;             // padded row stride
  static constexpr int PS = kBQ + 4;           // P^T and dS^T row stride
  // of the q items: one at D 256, where two do not fit, and at D 64,
  // where one lets two blocks share an SM; two blocks at D 16 and 32 held
  // a thread to 128 registers and were slower than one (chip_variants.py)
  static constexpr int STAGES = D == 64 || D > 128 ? 1 : 2;
  static constexpr int DC = D / 16 / (PAIR ? 2 : 1);  // dK, dV head dims
  static constexpr int VW = piece_width(DC);   // a q or dO row's piece
  static constexpr int k = 0;                  // [BK][RS]
  static constexpr int v = k + BK * RS;        // [BK][RS]
  static constexpr int q = v + BK * RS;        // [STAGES][kBQ][RS]
  static constexpr int dout = q + STAGES * kBQ * RS;   // [STAGES][kBQ][RS]
  // [BK][PS] P^T, then dS^T in its place; two buffers, P^T and dS^T,
  // where the halves exchange them
  static constexpr int pd = dout + STAGES * kBQ * RS;
  static constexpr int lse = pd + (PAIR ? 2 : 1) * BK * PS;  // [STAGES][kBQ]
  static constexpr int delta = lse + STAGES * kBQ;     // [STAGES][kBQ]
  static constexpr int qseg = delta + STAGES * kBQ;    // [STAGES][kBQ] int
  static constexpr size_t bytes = 4 * (size_t)(qseg + STAGES * kBQ);
  static constexpr int min_blocks = D == 64 ? 2 : 1;
};
static_assert(2 * DkvF32<64>::bytes + 2048 <= 233472, "K4 f32 at D 64");
static_assert(DkvF32<128>::bytes <= 232448 && DkvF32<256>::bytes <= 232448,
              "K4 f32 shared memory");

// dS of this thread's A x 4 patch of a kv tile (rows ty + TY i) from S
// and dP; masked only where the tile needs it (a tile template per case:
// see online_softmax in flash_fwd.cu for what ptxas does with one loop
// predicated on a flag)
template <int A, int TY, bool kMask>
__device__ __forceinline__ void dq_f32_ds(
    const BwdParams& p, float (*s)[4], float (*dp)[4], const float* lse,
    const float* delta, const int* qs, const int* ks, float* ds_s, int ps,
    int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep =
          !kMask || live(p, q0 + ty + TY * i, k0 + c, qs[i], ks[c]);
      const float pr = keep ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
      ds_s[(ty + TY * i) * ps + c] = pr * (dp[i][j] - delta[i]) * p.scale;
    }
}

template <int D>
__global__ void __launch_bounds__(DqF32<D>::NT, DqF32<D>::min_blocks)
bwd_dq_f32(BwdParams p, int B) {
  using L = DqF32<D>;
  constexpr int BQ = L::BQ, A = L::A, RS = L::RS, PS = L::PS;
  constexpr int NT = L::NT, TY = L::TY;
  constexpr int DC = L::DC, VW = L::VW, NV = DC / VW;
  const int n_qt = (p.sq + BQ - 1) / BQ;
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.hq * B));
  const int rest = blockIdx.x % (p.hq * B);
  const int h = rest % p.hq, b = rest / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BQ;
  const bool vec16 = p.vec16 != 0;

  extern __shared__ __align__(16) float dq_smem[];
  float* q_s = dq_smem + L::q;
  float* do_s = dq_smem + L::dout;
  float* v_s = dq_smem + L::v;
  float* ds_s = dq_smem + L::ds;
  int* kseg_s = reinterpret_cast<int*>(dq_smem + L::kseg);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load_k = [&](int kb, int st) {  // K tile kb and its kv segment ids
    stage_rows<D, RS, NT>(dq_smem + L::k + st * kBK * RS, k, p.k_ss,
                          kb * kBK, kBK, p.sk, vec16);
    if (p.kseg != nullptr && tid < kBK) {
      const int kpos = kb * kBK + tid;
      kseg_s[st * kBK + tid] =
          kpos < p.sk ? p.kseg[(size_t)b * p.sk + kpos] : 0;
    }
  };

  // commit groups, in order: q and do; K 0 and V 0; K 1 (two stages);
  // then per tile kb: V kb + 1, and K kb + 2 (two stages) or kb + 1
  const int n_kb = kv_tiles(p, q0, BQ);
  stage_rows<D, RS, NT>(q_s, q, p.q_ss, q0, BQ, p.sq, vec16);
  stage_rows<D, RS, NT>(do_s, dout, p.o_ss, q0, BQ, p.sq, vec16);
  cp_async_commit();
  if (n_kb > 0) {
    load_k(0, 0);
    stage_rows<D, RS, NT>(v_s, v, p.v_ss, 0, kBK, p.sk, vec16);
  }
  cp_async_commit();
  if (L::KSTAGES == 2 && n_kb > 1) load_k(1, 1);
  cp_async_commit();

  float lse[A], delta[A], acc[A][DC];
  int qs[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int qpos = q0 + ty + TY * i;
    const bool in = qpos < p.sq;  // rows past sq: q = do = 0, so dS = 0
    lse[i] = in ? p.lse[row_index(p, b, qpos, h)] : 0.f;
    delta[i] = in ? p.delta[row_index(p, b, qpos, h)] : 0.f;
    qs[i] = p.qseg != nullptr
                ? p.qseg[(size_t)b * p.sq + min(qpos, p.sq - 1)] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = L::KSTAGES == 2 ? kb & 1 : 0, k0 = kb * kBK;
    const float* k_s = dq_smem + L::k + st * kBK * RS;
    if (L::KSTAGES == 2)
      cp_async_wait<1>();  // all but K kb + 1
    else
      cp_async_wait<0>();
    __syncthreads();  // K, V and the segment ids of tile kb are in

    // S = Q K^T and dP = dO V^T: rows ty + 16 i, columns tx + 16 j
    float s[A][4], dp[A][4];
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 kf[4], vf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = lds4(k_s + (tx + 16 * j) * RS + e);
        vf[j] = lds4(v_s + (tx + 16 * j) * RS + e);
      }
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float4 qf = lds4(q_s + (ty + TY * i) * RS + e);
        const float4 of = lds4(do_s + (ty + TY * i) * RS + e);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qf, kf[j], s[i][j]);
          dp[i][j] = dot4(of, vf[j], dp[i][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with V kb: refill it
    if (kb + 1 < n_kb)
      stage_rows<D, RS, NT>(v_s, v, p.v_ss, k0 + kBK, kBK, p.sk, vec16);
    cp_async_commit();

    // dS into shared memory; a row's writers and readers are one warp
    const int* ks = kseg_s + st * kBK;
    if (p.kseg != nullptr || k0 + kBK > p.sk ||
        (p.causal && k0 + kBK - 1 > q0 + (p.sk - p.sq)))
      dq_f32_ds<A, TY, true>(p, s, dp, lse, delta, qs, ks, ds_s, PS, q0, k0,
                             ty, tx);
    else
      dq_f32_ds<A, TY, false>(p, s, dp, lse, delta, qs, ks, ds_s, PS, q0,
                              k0, ty, tx);
    __syncwarp();

    // dQ += dS K: rows ty + 16 i, head dims VW tx + 16 VW n + w
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 d4[A];
#pragma unroll
      for (int i = 0; i < A; ++i) d4[i] = lds4(ds_s + (ty + TY * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* k_row = k_s + (c + cc) * RS + VW * tx;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float kv[VW];
          if constexpr (VW == 4) {
            const float4 x = lds4(k_row + 16 * VW * n);
            kv[0] = x.x; kv[1] = x.y; kv[2] = x.z; kv[3] = x.w;
          } else if constexpr (VW == 2) {
            const float2 x =
                *reinterpret_cast<const float2*>(k_row + 16 * VW * n);
            kv[0] = x.x; kv[1] = x.y;
          } else {
            kv[0] = k_row[16 * n];
          }
#pragma unroll
          for (int i = 0; i < A; ++i) {
            const float dsv = (&d4[i].x)[cc];
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][n * VW + w] = fmaf(dsv, kv[w], acc[i][n * VW + w]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with K kb: refill its stage
    const int next = kb + L::KSTAGES;
    if (next < n_kb) load_k(next, st);
    cp_async_commit();
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= p.sq) continue;
    float* row = dq + row_index(p, b, qpos, h) * D + VW * tx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int w = 0; w < VW; ++w) row[16 * VW * n + w] = acc[i][n * VW + w];
  }
}

// S^T (or dP^T) of this thread's A x 4 patch: the kv rows ty + TY i of
// a_s (k or v) against the q columns tx + 16 j of x_s (q or dO), 4 head
// dims at a time
template <int D, int A, int TY>
__device__ __forceinline__ void dkv_f32_scores(float (*s)[4],
                                               const float* a_s,
                                               const float* x_s, int ty,
                                               int tx) {
  constexpr int RS = DkvF32<D>::RS;
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < D; e += 4) {
    float4 xf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xf[j] = lds4(x_s + (tx + 16 * j) * RS + e);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float4 af = lds4(a_s + (ty + TY * i) * RS + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(af, xf[j], s[i][j]);
    }
  }
}

// P^T of this thread's patch from S^T, in place, masked only where the
// item needs it (a template per case, as dq_f32_ds): a masked pair's p is
// 0 and its exp is skipped
template <int A, int TY, bool kMask>
__device__ __forceinline__ void dkv_f32_p(const BwdParams& p, float (*s)[4],
                                          const float* lse, const int* qs,
                                          const int* ks, int q0, int k0,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = !kMask || live(p, q0 + tx + 16 * j,
                                       k0 + ty + TY * i, qs[j], ks[i]);
      s[i][j] = keep ? expf(s[i][j] * p.scale - lse[j]) : 0.f;
    }
}

// acc[i] += sum over the item's kBQ q rows c of t[ty + TY i][c] x[c]: t
// this thread's rows of P^T or dS^T (4 columns a float4), x the item's dO
// or q rows at head dims VW tx + 16 VW n + w (of the half's at D 256)
template <int D, int A, int TY>
__device__ __forceinline__ void dkv_f32_acc(float (*acc)[DkvF32<D>::DC],
                                            const float* t_s,
                                            const float* x_s, int ty,
                                            int tx) {
  using L = DkvF32<D>;
  constexpr int VW = L::VW, NV = L::DC / VW;
#pragma unroll 2
  for (int c = 0; c < kBQ; c += 4) {
    float4 t4[A];
#pragma unroll
    for (int i = 0; i < A; ++i) t4[i] = lds4(t_s + (ty + TY * i) * L::PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* x_row = x_s + (c + cc) * L::RS + VW * tx;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float xv[VW];
        lds_piece<VW>(x_row + 16 * VW * n, xv);
#pragma unroll
        for (int i = 0; i < A; ++i) {
          const float tv = (&t4[i].x)[cc];
#pragma unroll
          for (int w = 0; w < VW; ++w)
            acc[i][n * VW + w] = fmaf(tv, xv[w], acc[i][n * VW + w]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvF32<D>::NT, DkvF32<D>::min_blocks)
bwd_dkv_f32(BwdParams p, int B) {
  using L = DkvF32<D>;
  constexpr int BK = L::BK, A = L::A, RS = L::RS, NT = L::NT, TY = L::TY;
  constexpr int DC = L::DC, VW = L::VW, NV = DC / VW;
  // heaviest first: under causal masking the first kv tiles see most q
  const int per_tile = p.hkv * B;
  const int kt = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int hk = rest % p.hkv, b = rest / p.hkv;
  const int rep = p.hq / p.hkv;
  const int tid = threadIdx.x, half = L::PAIR ? tid / (NT / 2) : 0;
  const int ty = tid % (NT / (L::PAIR ? 2 : 1)) / 16, tx = tid % 16;
  const int k0 = kt * BK, offset = p.sk - p.sq;
  const bool vec16 = p.vec16 != 0;

  extern __shared__ __align__(16) float dkv_smem[];
  const float* k_s = dkv_smem + L::k;
  const float* v_s = dkv_smem + L::v;
  float* pd_s = dkv_smem + L::pd;

  // the (q head, q tile) items from the causal start, q heads outer; item
  // it into stage st: its q and dO rows, lse, delta and q segment ids
  const int qb0 = first_q_tile(p, k0);
  const int nq = max((p.sq + kBQ - 1) / kBQ - qb0, 0), n_items = rep * nq;
  auto load_item = [&](int it, int st) {
    const int h = hk * rep + it / nq, q0 = (qb0 + it % nq) * kBQ;
    stage_rows<D, RS, NT>(
        dkv_smem + L::q + st * kBQ * RS,
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
        q0, kBQ, p.sq, vec16);
    stage_rows<D, RS, NT>(
        dkv_smem + L::dout + st * kBQ * RS,
        static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh,
        p.o_ss, q0, kBQ, p.sq, vec16);
    if (tid < kBQ) {  // rows past sq: zeros
      const int qpos = min(q0 + tid, p.sq - 1);
      const int n = q0 + tid < p.sq ? 4 : 0;
      const int at = st * kBQ + tid;
      cp_async<4>(dkv_smem + L::lse + at, p.lse + row_index(p, b, qpos, h),
                  n);
      cp_async<4>(dkv_smem + L::delta + at,
                  p.delta + row_index(p, b, qpos, h), n);
      if (p.qseg != nullptr)
        cp_async<4>(dkv_smem + L::qseg + at, p.qseg + (size_t)b * p.sq + qpos,
                    n);
    }
  };

  // the first commit group: K, V and item 0. Then, with two stages, item
  // it + 1 at the start of item it; with one, after item it
  stage_rows<D, RS, NT>(
      dkv_smem + L::k,
      static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0,
      BK, p.sk, vec16);
  stage_rows<D, RS, NT>(
      dkv_smem + L::v,
      static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0,
      BK, p.sk, vec16);
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  float dk[A][DC], dv[A][DC];
  int ks[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int kpos = min(k0 + ty + TY * i, p.sk - 1);
    ks[i] = p.kseg != nullptr ? p.kseg[(size_t)b * p.sk + kpos] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int it = 0; it < n_items; ++it) {
    const int st = L::STAGES == 2 ? it & 1 : 0;
    const int q0 = (qb0 + it % nq) * kBQ;
    cp_async_wait<0>();  // item it
    __syncthreads();     // ... visible; every warp is done with item it - 1
    if (L::STAGES == 2) {
      if (it + 1 < n_items) load_item(it + 1, st ^ 1);
      cp_async_commit();
    }
    const float* q_s = dkv_smem + L::q + st * kBQ * RS;
    const float* do_s = dkv_smem + L::dout + st * kBQ * RS;
    float lse[4], delta[4];
    int qs[4];  // of this thread's q columns tx + 16 j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = st * kBQ + tx + 16 * j;
      lse[j] = dkv_smem[L::lse + at];
      delta[j] = dkv_smem[L::delta + at];
      qs[j] = p.qseg != nullptr
                  ? reinterpret_cast<const int*>(dkv_smem + L::qseg)[at] : 0;
    }

    const bool mask = p.kseg != nullptr || k0 + BK > p.sk ||
                      q0 + kBQ > p.sq ||
                      (p.causal && k0 + BK - 1 > q0 + offset);
    if constexpr (L::PAIR) {
      // half 0: S^T = K Q^T and P^T; half 1: dP^T = V dO^T and then dS^T
      // from the P^T that half 0 wrote; each half then adds its head dims
      // of dV += P^T dO and dK += dS^T Q
      float* p_s = pd_s;
      float* ds_s = pd_s + BK * L::PS;
      float sc[A][4];
      if (half == 0) {
        dkv_f32_scores<D, A, TY>(sc, k_s, q_s, ty, tx);
        if (mask)
          dkv_f32_p<A, TY, true>(p, sc, lse, qs, ks, q0, k0, ty, tx);
        else
          dkv_f32_p<A, TY, false>(p, sc, lse, qs, ks, q0, k0, ty, tx);
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p_s[(ty + TY * i) * L::PS + tx + 16 * j] = sc[i][j];
      } else {
        dkv_f32_scores<D, A, TY>(sc, v_s, do_s, ty, tx);
      }
      __syncthreads();  // P^T is in
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = (ty + TY * i) * L::PS + tx + 16 * j;
            ds_s[at] = p_s[at] * (sc[i][j] - delta[j]) * p.scale;
          }
      }
      __syncthreads();  // dS^T is in
      dkv_f32_acc<D, A, TY>(dv, p_s, do_s + half * (D / 2), ty, tx);
      dkv_f32_acc<D, A, TY>(dk, ds_s, q_s + half * (D / 2), ty, tx);
    } else {
      // S^T = K Q^T and dP^T = V dO^T: kv rows ty + TY i, q columns tx + 16 j
      float s[A][4], dp[A][4];
      dkv_f32_scores<D, A, TY>(s, k_s, q_s, ty, tx);
      dkv_f32_scores<D, A, TY>(dp, v_s, do_s, ty, tx);

      // P^T in s (masked only where the item needs it), into the rows'
      // block of pd_s: a row's writers and readers are one warp
      if (mask)
        dkv_f32_p<A, TY, true>(p, s, lse, qs, ks, q0, k0, ty, tx);
      else
        dkv_f32_p<A, TY, false>(p, s, lse, qs, ks, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pd_s[(ty + TY * i) * L::PS + tx + 16 * j] = s[i][j];
      __syncwarp();
      dkv_f32_acc<D, A, TY>(dv, pd_s, do_s, ty, tx);  // dV += P^T dO
      __syncwarp();  // every lane has read P^T: dS^T takes its place
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pd_s[(ty + TY * i) * L::PS + tx + 16 * j] =
              s[i][j] * (dp[i][j] - delta[j]) * p.scale;
      __syncwarp();
      dkv_f32_acc<D, A, TY>(dk, pd_s, q_s, ty, tx);  // dK += dS^T Q
    }

    if (L::STAGES == 1) {
      __syncthreads();  // every warp is done with the stage: refill it
      if (it + 1 < n_items) load_item(it + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (no item: K's and V's)

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int kpos = k0 + ty + TY * i;
    if (kpos >= p.sk) continue;
    const size_t row = (((size_t)b * p.sk + kpos) * p.hkv + hk) * D +
                       half * (D / 2) + VW * tx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        dk_out[row + 16 * VW * n + w] = dk[i][n * VW + w];
        dv_out[row + 16 * VW * n + w] = dv[i][n * VW + w];
      }
  }
}

// ---------------------------------------------------------------------
// K4 for Hopper, bf16: wgmma on operands in shared memory, filled by TMA
// through an mbarrier ring. One warpgroup (128 threads) per (64-row kv
// tile, kv head, batch row); warp w owns kv rows 16w..16w+15. K and V are
// loaded once. The (group head, q tile) items from the causal start
// stream through kStages ring slots: thread 0 loads each Q and dO tile by
// TMA, and the threads stage its lse (times log2(e)), delta and q segment
// ids beside it. Per item:
//   S^T = K Q^T and dP^T = V dO^T: wgmma, all four operands K-major as
//     stored;
//   p^T = exp2(s^T scale log2(e) - lse log2(e)), zeroed for a masked pair
//     without taking its exp (masks tested only on tiles that need them),
//     and ds^T = p^T (dp^T - delta) scale, on the accumulator registers;
//   dV += P^T dO and dK += dS^T Q: wgmma with P^T and dS^T rounded to
//     bf16 in registers as the A operand (as the TPU kernel rounds them),
//     dO and Q MN-major through the transpose bit: no transposed copy.
// dK and dV stay in float32 registers for the whole GQA group. The grid
// runs the heaviest blocks first: kv tile 0 of every (kv head, batch
// row), then tile 1, ... At D 256 dK and dV alone would take 256 float32
// registers a thread: bwd_dkv_wgmma_pair below takes that head dim.
constexpr int kWgThreads = 128;
constexpr int kStages = 2;  // ring slots of (Q, dO, lse, delta, q segments)

template <int D>
struct DkvSmem {  // byte offsets into the 1024-aligned shared memory
  static constexpr int tile = 64 * D * 2;  // one [64][D] bf16 tile
  static constexpr int k = 0, v = tile;
  static constexpr int q = 2 * tile;                  // kStages Q tiles
  static constexpr int dout = q + kStages * tile;     // kStages dO tiles
  static constexpr int vec = dout + kStages * tile;   // [kStages][3][kBQ]
  static constexpr int bars = vec + kStages * 3 * kBQ * 4;  // K/V, stages
  static constexpr int bytes = bars + (1 + kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
bwd_dkv_wgmma(const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap omap, BwdParams p, int B) {
  using L = DkvSmem<D>;
  static_assert(D <= 128, "D 256 is bwd_dkv_wgmma_pair's");
  constexpr int NO = D / 2;  // dk (and dv) accumulators per thread
  constexpr int KK = D / 16;
  const int per_tile = p.hkv * B;
  const int kt = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int hk = rest % p.hkv, b = rest / p.hkv;
  const int rep = p.hq / p.hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = kt * kBK, offset = p.sk - p.sq;
  const int qb0 = first_q_tile(p, k0);
  const int per_head = (p.sq + kBQ - 1) / kBQ - qb0;
  const int n_items = rep * per_head;
  const float scale_log2 = p.scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  unsigned char* q_s = smem + L::q;
  unsigned char* do_s = smem + L::dout;
  float* vec_s = reinterpret_cast<float*>(smem + L::vec);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;

  // item i: q head hk * rep + i / per_head, q tile qb0 + i % per_head
  auto load_tiles = [&](int i, int slot) {
    const int h = hk * rep + i / per_head;
    const int q0 = (qb0 + i % per_head) * kBQ;
    mbar_expect_tx(&full[slot], 2 * L::tile);
    tma_load_tile<D, kBQ>(q_s + slot * L::tile, &qmap, &full[slot], q0, h, b);
    tma_load_tile<D, kBQ>(do_s + slot * L::tile, &omap, &full[slot], q0, h,
                          b);
  };
  auto load_vecs = [&](int i, int slot) {  // threads 0..kBQ-1
    const int h = hk * rep + i / per_head;
    const int qpos = (qb0 + i % per_head) * kBQ + tid;
    const bool in = qpos < p.sq;
    float* v = vec_s + slot * 3 * kBQ;
    v[tid] = in ? p.lse[row_index(p, b, qpos, h)] * kLog2e : 0.f;
    v[kBQ + tid] = in ? p.delta[row_index(p, b, qpos, h)] : 0.f;
    reinterpret_cast<int*>(v)[2 * kBQ + tid] =
        in && p.qseg != nullptr ? p.qseg[(size_t)b * p.sq + qpos] : 0;
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(kvbar, 2 * L::tile);
    tma_load_tile<D, kBK>(k_s, &kmap, kvbar, k0, hk, b);
    tma_load_tile<D, kBK>(v_s, &vmap, kvbar, k0, hk, b);
    for (int s = 0; s < kStages && s < n_items; ++s) load_tiles(s, s);
  }
  if (tid < kBQ)
    for (int s = 0; s < kStages && s < n_items; ++s) load_vecs(s, s);

  // this thread's two kv rows: k0 + 16 warp + g and 8 below
  int kpos[2], ks[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    kpos[rr] = k0 + warp * 16 + g + 8 * rr;
    ks[rr] = p.kseg != nullptr
                 ? p.kseg[(size_t)b * p.sk + min(kpos[rr], p.sk - 1)] : 0;
  }
  float dk[NO], dv[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  __syncthreads();  // barriers initialised, first vectors staged
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n_items; ++i) {
    const int st = i % kStages;
    const int q0 = (qb0 + i % per_head) * kBQ;
    const unsigned char* qt = q_s + st * L::tile;
    const unsigned char* ot = do_s + st * L::tile;
    const float* lse_s = vec_s + st * 3 * kBQ;
    const float* delta_s = lse_s + kBQ;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + kBQ);
    mbar_wait(&full[st], (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T
    wgmma_fence();
    fence_regs<32>(s);
    fence_regs<32>(dp);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(s, desc_kmajor<D, kBK>(k_s, kk),
                   desc_kmajor<D, kBQ>(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(dp, desc_kmajor<D, kBK>(v_s, kk),
                   desc_kmajor<D, kBQ>(ot, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // P^T over S^T, dS^T over dP^T
    const bool need_mask = p.kseg != nullptr || q0 + kBQ > p.sq ||
                           k0 + kBK > p.sk ||
                           (p.causal && k0 + kBK - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
          const bool keep =
              !need_mask || live(p, q0 + c, kpos[rr], qseg_s[c], ks[rr]);
          const float pr =
              keep ? exp2f(s[idx] * scale_log2 - lse_s[c]) : 0.f;
          s[idx] = pr;
          dp[idx] = pr * (dp[idx] - delta_s[c]) * p.scale;
        }

    // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int t = 0; t < kBQ / 16; ++t) wg_frag(a[t], s, t);
    wgmma_fence();
    fence_regs<NO>(dv);
#pragma unroll
    for (int t = 0; t < kBQ / 16; ++t)
      wgmma_rs<D>(dv, a[t], desc_mnmajor<D, kBQ>(ot, t), 1);
#pragma unroll
    for (int t = 0; t < kBQ / 16; ++t) wg_frag(a[t], dp, t);
    wgmma_fence();
    fence_regs<NO>(dk);
#pragma unroll
    for (int t = 0; t < kBQ / 16; ++t)
      wgmma_rs<D>(dk, a[t], desc_mnmajor<D, kBQ>(qt, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(dv);
    fence_regs<NO>(dk);

    __syncthreads();  // every thread is done with slot st
    if (i + kStages < n_items) {
      if (tid == 0) load_tiles(i + kStages, st);
      if (tid < kBQ) load_vecs(i + kStages, st);
    }
  }

  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (kpos[rr] >= p.sk) continue;
    const size_t row = (((size_t)b * p.sk + kpos[rr]) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dk_out + row + col) =
          pack_bf16(dk[4 * j + 2 * rr], dk[4 * j + 2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + row + col) =
          pack_bf16(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
    }
  }
}

// P^T = exp2(s^T scale log2(e) - lse log2(e)) on this thread's 32
// accumulators of S^T (kv rows kpos[0], kpos[1], q columns 8j + 2tq + e),
// zeroed for a masked pair without taking its exp. Instantiated with and
// without the masks and chosen per tile, so that a tile needing none runs
// its exps back to back (one version predicated on a runtime flag
// serialised them).
template <bool kMask>
__device__ __forceinline__ void probs_t(float* x, const BwdParams& p, int q0,
                                        const int* kpos, const int* ks,
                                        const int* qseg_s, const float* lse_s,
                                        int tq, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
        const bool keep =
            !kMask || live(p, q0 + c, kpos[rr], qseg_s[c], ks[rr]);
        x[idx] = keep ? exp2f(x[idx] * scale_log2 - lse_s[c]) : 0.f;
      }
}

// ---------------------------------------------------------------------
// K4 for Hopper at D 256, bf16: bwd_dkv_wgmma's loads, items and
// rounding, with one block of two consumer warpgroups (256 threads) per
// (64-row kv tile, kv head, batch row), so S^T and dP^T are each computed
// once and every tile is read once. Per item:
//   warpgroup 0 runs S^T = K Q^T and warpgroup 1 dP^T = V dO^T, each
//     over the whole depth D;
//   warpgroup 0 forms P^T (masked as bwd_dkv_wgmma does) and writes it in
//     float32 to shared memory in the accumulator's own per-thread order
//     (thread t of one warpgroup holds the same (row, column) positions as
//     thread t of the other, so no swizzle is involved): 16 KB;
//   warpgroup 1 reads it and forms dS^T = P^T (dP^T - delta) scale, and
//     hands dS^T's bf16 A fragments back the same way: 8 KB;
//   warpgroup w owns dK's and dV's columns [128w, 128w + 128):
//     dV[:, cols] += P^T dO[:, cols] and dK[:, cols] += dS^T Q[:, cols]
//     (wgmma_rs<128>, dO and Q MN-major from column 128w).
// That is 4 products per (kv tile, q tile) pair, K4's bound's count, split
// evenly over the two warpgroups (the one-warpgroup design took two
// blocks, each computing S^T and dP^T again: 6). A thread holds 64 dK and
// 64 dV accumulators, 32 of S^T or dP^T and the fragments. p and ds are
// rounded to bf16 where bwd_dkv_wgmma rounds them, and each product is the
// same wgmma on the same operands, so dK and dV equal that design's bit
// for bit. Two named barriers order the exchange: 1 "P^T written", 2
// "dS^T written"; warpgroup 0 runs its dV product while warpgroup 1 forms
// dS^T.
template <int D>
struct DkvPairSmem : DkvSmem<D> {  // DkvSmem's ring, then the exchange
  static constexpr int pt = DkvSmem<D>::bars + (1 + kStages) * 8;
  static constexpr int ds = pt + 32 * kWgThreads * 4;  // [32][128] float
  static constexpr int bytes = ds + 16 * kWgThreads * 4;  // [16][128] u32
};
static_assert(DkvPairSmem<256>::bytes + kSmemSlack <= 232448,
              "K4's two-warpgroup shared memory");

// Warpgroup WG's half of bwd_dkv_wgmma_pair's work. WG is a template
// parameter, so no branch or descriptor below depends on the warpgroup at
// run time.
template <int D, int WG, class Tiles, class Vecs>
__device__ __forceinline__ void dkv_pair_cols(unsigned char* smem,
                                              const BwdParams& p, int b,
                                              int hk, int k0, int qb0,
                                              int per_head, int n_items,
                                              Tiles load_tiles,
                                              Vecs load_vecs) {
  using L = DkvPairSmem<D>;
  constexpr int NC = D / 2;   // this warpgroup's columns of dk and dv
  constexpr int NO = NC / 2;  // dk (and dv) accumulators per thread
  constexpr int KK = D / 16;
  constexpr int kPair = 2 * kWgThreads;  // threads of a named barrier
  constexpr int col0 = WG * NC;
  const int tid = threadIdx.x, t = tid % kWgThreads;
  const int warp = t / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = p.sk - p.sq;
  const float scale_log2 = p.scale * kLog2e;
  // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
  const unsigned char* a_s = smem + (WG == 0 ? L::k : L::v);
  const unsigned char* q_s = smem + L::q;
  const unsigned char* do_s = smem + L::dout;
  const float* vec_s = reinterpret_cast<const float*>(smem + L::vec);
  float* pt_s = reinterpret_cast<float*>(smem + L::pt);
  uint32_t* ds_s = reinterpret_cast<uint32_t*>(smem + L::ds);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;

  // this thread's two kv rows: k0 + 16 warp + g and 8 below
  int kpos[2], ks[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    kpos[rr] = k0 + warp * 16 + g + 8 * rr;
    ks[rr] = p.kseg != nullptr
                 ? p.kseg[(size_t)b * p.sk + min(kpos[rr], p.sk - 1)] : 0;
  }
  float dk[NO], dv[NO], x[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n_items; ++i) {
    const int st = i % kStages;
    const int q0 = (qb0 + i % per_head) * kBQ;
    const unsigned char* qt = q_s + st * L::tile;
    const unsigned char* ot = do_s + st * L::tile;
    const float* lse_s = vec_s + st * 3 * kBQ;
    const float* delta_s = lse_s + kBQ;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + kBQ);
    mbar_wait(&full[st], (i / kStages) & 1);

    // x = S^T (warpgroup 0) or dP^T (warpgroup 1)
    const unsigned char* bt = WG == 0 ? qt : ot;
    wgmma_fence();
    fence_regs<32>(x);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(x, desc_kmajor<D, kBK>(a_s, kk),
                   desc_kmajor<D, kBQ>(bt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(x);

    uint32_t pa[4][4], da[4][4];  // A fragments of P^T and dS^T
    if (WG == 0) {  // P^T over S^T, to the other warpgroup
      if (p.kseg != nullptr || q0 + kBQ > p.sq || k0 + kBK > p.sk ||
          (p.causal && k0 + kBK - 1 > q0 + offset))
        probs_t<true>(x, p, q0, kpos, ks, qseg_s, lse_s, tq, scale_log2);
      else
        probs_t<false>(x, p, q0, kpos, ks, qseg_s, lse_s, tq, scale_log2);
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) pt_s[idx * kWgThreads + t] = x[idx];
      named_arrive(1, kPair);
#pragma unroll
      for (int tt = 0; tt < kBQ / 16; ++tt) wg_frag(pa[tt], x, tt);
    } else {  // dS^T over dP^T and the other warpgroup's P^T, and back
      named_sync(1, kPair);
      float pr[32];
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) pr[idx] = pt_s[idx * kWgThreads + t];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
            x[idx] = pr[idx] * (x[idx] - delta_s[c]) * p.scale;
          }
#pragma unroll
      for (int tt = 0; tt < kBQ / 16; ++tt) {
        wg_frag(pa[tt], pr, tt);
        wg_frag(da[tt], x, tt);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) ds_s[j * kWgThreads + t] = da[j / 4][j % 4];
      named_arrive(2, kPair);
    }

    // dV[:, cols] += P^T dO[:, cols]
    wgmma_fence();
    fence_regs<NO>(dv);
#pragma unroll
    for (int tt = 0; tt < kBQ / 16; ++tt)
      wgmma_rs<NC>(dv, pa[tt], desc_mnmajor<D, kBQ>(ot, tt, col0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(dv);

    if (WG == 0) {  // the other warpgroup's dS^T fragments
      named_sync(2, kPair);
#pragma unroll
      for (int j = 0; j < 16; ++j) da[j / 4][j % 4] = ds_s[j * kWgThreads + t];
    }

    // dK[:, cols] += dS^T Q[:, cols]
    wgmma_fence();
    fence_regs<NO>(dk);
#pragma unroll
    for (int tt = 0; tt < kBQ / 16; ++tt)
      wgmma_rs<NC>(dk, da[tt], desc_mnmajor<D, kBQ>(qt, tt, col0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(dk);

    named_sync(3, kPair);  // both warpgroups are done with slot st
    if (WG == 0 && i + kStages < n_items) {
      if (t == 0) load_tiles(i + kStages, st);
      if (t < kBQ) load_vecs(i + kStages, st);
    }
  }

  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (kpos[rr] >= p.sk) continue;
    const size_t row = (((size_t)b * p.sk + kpos[rr]) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = col0 + j * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dk_out + row + col) =
          pack_bf16(dk[4 * j + 2 * rr], dk[4 * j + 2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + row + col) =
          pack_bf16(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void
bwd_dkv_wgmma_pair(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap omap, BwdParams p,
                   int B) {
  using L = DkvPairSmem<D>;
  const int per_tile = p.hkv * B;
  const int kt = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int hk = rest % p.hkv, b = rest / p.hkv;
  const int rep = p.hq / p.hkv;
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  const int qb0 = first_q_tile(p, k0);
  const int per_head = (p.sq + kBQ - 1) / kBQ - qb0;
  const int n_items = rep * per_head;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* q_s = smem + L::q;
  unsigned char* do_s = smem + L::dout;
  float* vec_s = reinterpret_cast<float*>(smem + L::vec);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;

  // item i: q head hk * rep + i / per_head, q tile qb0 + i % per_head
  auto load_tiles = [&](int i, int slot) {  // thread 0
    const int h = hk * rep + i / per_head;
    const int q0 = (qb0 + i % per_head) * kBQ;
    mbar_expect_tx(&full[slot], 2 * L::tile);
    tma_load_tile<D, kBQ>(q_s + slot * L::tile, &qmap, &full[slot], q0, h,
                          b);
    tma_load_tile<D, kBQ>(do_s + slot * L::tile, &omap, &full[slot], q0, h,
                          b);
  };
  auto load_vecs = [&](int i, int slot) {  // threads 0..kBQ-1
    const int h = hk * rep + i / per_head;
    const int qpos = (qb0 + i % per_head) * kBQ + tid;
    const bool in = qpos < p.sq;
    float* v = vec_s + slot * 3 * kBQ;
    v[tid] = in ? p.lse[row_index(p, b, qpos, h)] * kLog2e : 0.f;
    v[kBQ + tid] = in ? p.delta[row_index(p, b, qpos, h)] : 0.f;
    reinterpret_cast<int*>(v)[2 * kBQ + tid] =
        in && p.qseg != nullptr ? p.qseg[(size_t)b * p.sq + qpos] : 0;
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(kvbar, 2 * L::tile);
    tma_load_tile<D, kBK>(smem + L::k, &kmap, kvbar, k0, hk, b);
    tma_load_tile<D, kBK>(smem + L::v, &vmap, kvbar, k0, hk, b);
    for (int s = 0; s < kStages && s < n_items; ++s) load_tiles(s, s);
  }
  if (tid < kBQ)
    for (int s = 0; s < kStages && s < n_items; ++s) load_vecs(s, s);
  __syncthreads();  // barriers initialised, first vectors staged

  if (tid < kWgThreads)
    dkv_pair_cols<D, 0>(smem, p, b, hk, k0, qb0, per_head, n_items,
                        load_tiles, load_vecs);
  else
    dkv_pair_cols<D, 1>(smem, p, b, hk, k0, qb0, per_head, n_items,
                        load_tiles, load_vecs);
}

// ---------------------------------------------------------------------
// K4 for Hopper at D 96, bf16: two warpgroups over a 128-row kv tile,
// whose ring stages are released without a block barrier. One
// block per (128-row kv tile, kv head, batch row); warpgroup w owns kv
// rows k0 + 64w .. k0 + 64w + 63 and all D columns of their dK and dV (48
// + 48 float32 accumulators a thread at D 96: nothing is exchanged). Both
// warpgroups read each ring stage once (Q, dO, lse, delta, q segment
// ids), which halves the q-side loads and waits per kv row; the K and V
// tiles of the 128 rows load once. Per item, in bwd_dkv_wgmma's order (q
// heads of the GQA group, then q tiles from the causal start of the
// block's first row), each warpgroup runs bwd_dkv_wgmma's four products
// on its 64 rows and rounds P^T and dS^T to bf16 at the same place, so dK
// and dV equal that kernel's bit for bit. What held that kernel back, and
// what this one does about it:
//   - each item ran in series (products, wait, exps, products, wait,
//     block barrier) and the tensor cores idled through the exps: here
//     the warpgroups take turns at the tensor cores (named barriers 1 and
//     2 pass a token: warpgroup w waits on 1 + w before it issues its
//     products and hands the turn over as soon as they are issued), so
//     one warpgroup's exps and dS^T run while the other's products
//     occupy them (FlashAttention-3's ping-pong);
//   - a stage was released by a block barrier: here, at its turn for
//     item i, warpgroup 1 knows that both warpgroups are done with item
//     i - 1 (warpgroup 0 has issued item i's products) and refills that
//     stage with item i - 1 + S, all its threads alike: thread 0 issues
//     the TMA of Q and dO, threads below 64 copy lse, delta and segment
//     ids by cp.async, whose landing arrives on the stage's "full"
//     mbarrier. The loads are predicated, not branched: a branch that
//     some threads of a warpgroup skip made ptxas serialise every wgmma
//     of the function;
//   - S^T = K Q^T and dP^T = V dO^T read K and V from registers (wgmma
//     with A from registers): the fragments of the warpgroup's 64 rows
//     load once, and each product reads one operand from shared memory
//     instead of two;
//   - the exps were predicated on a runtime mask flag, which ptxas
//     serialised: probs_rows<true/false> is chosen per item and
//     warpgroup.
// A warpgroup walks no item its rows cannot see under the causal bound
// (the two halves start one q tile apart) and none if its rows start at
// or past sk: there it only passes the token.
// Design constants, each measured against its alternative by
// chip_variants.py: ring stages, the grid order, K or V read from shared
// memory. A producer warpgroup under setmaxnreg and FlashAttention-3's
// intra-warpgroup overlap were slower and spilled (PERF.md has the
// readings).
// Shared memory at D 96 and 3 stages: 125,216 bytes, one block an SM.
// the head dims that take this design (D 96; chip_variants.py probes it
// at D 64 and 128, which keep bwd_dkv_wgmma)
__host__ __device__ constexpr bool rows_design(int d) { return d == 96; }
constexpr int kRowsStages = 3;          // Q/dO ring stages
constexpr bool kRowsHeavyFirst = true;  // kv tile 0 of every head first
constexpr bool kRowsKRegs = true;       // S^T with K's fragments in registers
constexpr bool kRowsVRegs = true;       // dP^T with V's fragments likewise

template <int D>
struct DkvRowsSmem {  // byte offsets into the 1024-aligned shared memory
  static constexpr int S = kRowsStages;
  static constexpr int tile = 64 * D * 2;  // one [64][D] bf16 tile
  static constexpr int k = 0, v = 2 * tile;           // 2 K, 2 V tiles
  static constexpr int q = 4 * tile;                  // S Q tiles
  static constexpr int dout = q + S * tile;           // S dO tiles
  static constexpr int vec = dout + S * tile;         // [S][3][kBQ]
  static constexpr int bars = vec + S * 3 * kBQ * 4;  // K/V, full
  static constexpr int bytes = bars + (1 + S) * 8;
  static constexpr int threads = 2 * kWgThreads;
  // warpgroup 1 refills the stage of item j at its turn for item j + 1
  static_assert(S > 1, "the ring must lead the refill");
};
static_assert(DkvRowsSmem<96>::bytes + kSmemSlack <= 232448,
              "K4's two-warpgroup ring at D 96");

// Copy row r of item i's lse, delta and q segment id (zeros past sq) into
// a stage's vectors by cp.async (as stored: the consumers scale lse),
// where `on`.
__device__ __forceinline__ void copy_vecs(bool on, const BwdParams& p, int b,
                                          int hk, int rep, int qb0,
                                          int per_head, int i, int r,
                                          float* v) {
  const int h = hk * rep + i / per_head;
  const int qpos = (qb0 + i % per_head) * kBQ + r;
  const bool in = qpos < p.sq;
  const size_t row = in ? row_index(p, b, qpos, h) : 0;
  cp_async4_if(on, v + r, p.lse + row, in ? 4 : 0);
  cp_async4_if(on, v + kBQ + r, p.delta + row, in ? 4 : 0);
  const bool seg = in && p.qseg != nullptr;
  cp_async4_if(on, v + 2 * kBQ + r,
               seg ? static_cast<const void*>(p.qseg + (size_t)b * p.sq +
                                              qpos)
                   : p.lse,
               seg ? 4 : 0);
}

// probs_t on a stage whose lse is stored unscaled: the same
// lse log2(e) product, rounded on its own as bwd_dkv_wgmma stores it, so
// the exps' arguments are the same bits
template <bool kMask>
__device__ __forceinline__ void probs_rows(float* x, const BwdParams& p,
                                           int q0, const int* kpos,
                                           const int* ks, const int* qseg_s,
                                           const float* lse_s, int tq,
                                           float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
        const bool keep =
            !kMask || live(p, q0 + c, kpos[rr], qseg_s[c], ks[rr]);
        const float l2 = __fmul_rn(lse_s[c], kLog2e);
        x[idx] = keep ? exp2f(x[idx] * scale_log2 - l2) : 0.f;
      }
}

// A warpgroup's S^T = K Q^T and dP^T = V dO^T on its 64 kv rows (K, V)
// and an item's 64 q rows (Q, dO), all K-major as stored, from the
// descriptors of their k16 step 0: wgmma issued, not committed.
// With kRowsKRegs, S^T takes K from this thread's fragments kf, and with
// kRowsVRegs dP^T V from vf (the same products, A read from registers).
template <int D>
__device__ __forceinline__ void st_dpt(float* s, float* dp, uint64_t k_d,
                                       uint64_t v_d, uint64_t q_d,
                                       uint64_t do_d,
                                       const uint32_t (*kf)[4],
                                       const uint32_t (*vf)[4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (kRowsKRegs)
      wgmma_rs_kb64(s, kf[kk], desc_advance(q_d, kmajor_off<D, kBQ>(kk)),
                    kk > 0);
    else
      wgmma_ss<64>(s, desc_advance(k_d, kmajor_off<D, kBK>(kk)),
                   desc_advance(q_d, kmajor_off<D, kBQ>(kk)), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (kRowsVRegs)
      wgmma_rs_kb64(dp, vf[kk], desc_advance(do_d, kmajor_off<D, kBQ>(kk)),
                    kk > 0);
    else
      wgmma_ss<64>(dp, desc_advance(v_d, kmajor_off<D, kBK>(kk)),
                   desc_advance(do_d, kmajor_off<D, kBQ>(kk)), kk > 0);
  }
}

// dV += P^T dO and dK += dS^T Q: A from registers (pa, da), dO and Q
// MN-major through the transpose bit, from the descriptors of their k16
// step 0; wgmma issued, not committed.
template <int D>
__device__ __forceinline__ void dv_dk(float* dv, float* dk,
                                      const uint32_t (*pa)[4],
                                      const uint32_t (*da)[4],
                                      uint64_t do_d, uint64_t q_d) {
#pragma unroll
  for (int tt = 0; tt < kBQ / 16; ++tt)
    wgmma_rs<D>(dv, pa[tt], desc_advance(do_d, mnmajor_off<D, kBQ>(tt)), 1);
#pragma unroll
  for (int tt = 0; tt < kBQ / 16; ++tt)
    wgmma_rs<D>(dk, da[tt], desc_advance(q_d, mnmajor_off<D, kBQ>(tt)), 1);
}

// P^T over S^T (masked where `masked`, chosen per item) and dS^T =
// P^T (dP^T - delta) scale over dP^T
__device__ __forceinline__ void probs_ds(bool masked, float* s, float* dp,
                                         const BwdParams& p, int q0,
                                         const int* kpos, const int* ks,
                                         const int* qseg_s,
                                         const float* lse_s,
                                         const float* delta_s, int tq,
                                         float scale_log2) {
  if (masked)
    probs_rows<true>(s, p, q0, kpos, ks, qseg_s, lse_s, tq, scale_log2);
  else
    probs_rows<false>(s, p, q0, kpos, ks, qseg_s, lse_s, tq, scale_log2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
        dp[idx] = s[idx] * (dp[idx] - delta_s[c]) * p.scale;
      }
}

// Warpgroup WG's rows of bwd_dkv_wgmma_rows' kv tile. WG is a template
// parameter, so no branch or descriptor below depends on the warpgroup at
// run time.
template <int D, int WG, class Refill>
__device__ __forceinline__ void dkv_rows(unsigned char* smem,
                                         const BwdParams& p, int b, int hk,
                                         int k0, int qb0, int per_head,
                                         int n_items, Refill refill) {
  using L = DkvRowsSmem<D>;
  constexpr int S = L::S;
  constexpr int NO = D / 2;  // dk (and dv) accumulators per thread
  constexpr int KK = D / 16;
  constexpr int kPair = 2 * kWgThreads;  // threads of a named barrier
  const int t = threadIdx.x % kWgThreads;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = p.sk - p.sq;
  const int kw = k0 + WG * kBK;  // this warpgroup's first kv row
  const int qbw = first_q_tile(p, kw);
  const bool rows_in = kw < p.sk;
  const float scale_log2 = p.scale * kLog2e;
  const unsigned char* k_s = smem + L::k + WG * L::tile;
  const unsigned char* v_s = smem + L::v + WG * L::tile;
  const unsigned char* q_s = smem + L::q;
  const unsigned char* do_s = smem + L::dout;
  const float* vec_s = reinterpret_cast<const float*>(smem + L::vec);
  // descriptors at k16 step 0: K and V K-major; stage 0's Q and dO K-major
  // and MN-major (a stage moves them by its offset)
  const uint64_t k_d = desc_kmajor<D, kBK>(k_s, 0);
  const uint64_t v_d = desc_kmajor<D, kBK>(v_s, 0);
  const uint64_t q_d = desc_kmajor<D, kBQ>(q_s, 0);
  const uint64_t do_d = desc_kmajor<D, kBQ>(do_s, 0);
  const uint64_t q_mn = desc_mnmajor<D, kBQ>(q_s, 0);
  const uint64_t do_mn = desc_mnmajor<D, kBQ>(do_s, 0);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;

  // this thread's two kv rows: kw + 16 warp + g and 8 below
  int kpos[2], ks[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    kpos[rr] = kw + warp * 16 + g + 8 * rr;
    ks[rr] = p.kseg != nullptr
                 ? p.kseg[(size_t)b * p.sk + min(kpos[rr], p.sk - 1)] : 0;
  }
  float dk[NO], dv[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t pa[4][4], da[4][4];  // A fragments of P^T and dS^T
  if (WG == 1 && n_items > 0) named_arrive(1, kPair);  // 0 goes first
  mbar_wait(kvbar, 0);
  uint32_t kf[kRowsKRegs ? KK : 1][4];  // K's A fragments
  uint32_t vf[kRowsVRegs ? KK : 1][4];  // V's
  if constexpr (kRowsKRegs)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      load_afrag<D, kBK>(kf[kk], k_s, warp, lane, kk);
  if constexpr (kRowsVRegs)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      load_afrag<D, kBK>(vf[kk], v_s, warp, lane, kk);

  for (int i = 0; i < n_items; ++i) {
    const int st = i % S;
    const int qt = qb0 + i % per_head, q0 = qt * kBQ;
    const bool active = rows_in && qt >= qbw;  // its rows see this item
    const float* lse_s = vec_s + st * 3 * kBQ;
    const float* delta_s = lse_s + kBQ;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + kBQ);
    if (active) mbar_wait(&full[st], (i / S) & 1);

    // S^T = K Q^T and dP^T = V dO^T, at this warpgroup's turn, which passes on once the products are
    // issued. Each product's issue and its wait stay in one branch: ptxas
    // serialises every wgmma of a function in which it cannot follow them.
    named_sync(1 + WG, kPair);
    const bool pass = WG == 0 || i + 1 < n_items;  // the other has a turn
    // warpgroup 0 has issued item i's products, so both warpgroups are
    // done with item i - 1's stage: warpgroup 1 refills it, all its
    // threads alike (predicated loads: no branch in the loop)
    if (WG == 1 && i >= 1 && i - 1 + S < n_items)
      refill(i - 1 + S, (i - 1) % S, t);
    const bool masked = p.kseg != nullptr || q0 + kBQ > p.sq ||
                        kw + kBK > p.sk ||
                        (p.causal && kw + kBK - 1 > q0 + offset);
    if (active) {
      wgmma_fence();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      st_dpt<D>(s, dp, k_d, v_d, desc_advance(q_d, st * L::tile),
                desc_advance(do_d, st * L::tile), kf, vf);
      wgmma_commit();
      if (pass) named_arrive(2 - WG, kPair);
      wgmma_wait<0>();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      probs_ds(masked, s, dp, p, q0, kpos, ks, qseg_s, lse_s, delta_s, tq,
               scale_log2);
      // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
#pragma unroll
      for (int tt = 0; tt < kBQ / 16; ++tt) {
        wg_frag(pa[tt], s, tt);
        wg_frag(da[tt], dp, tt);
      }
      wgmma_fence();
      fence_regs<NO>(dv);
      fence_regs<NO>(dk);
      dv_dk<D>(dv, dk, pa, da, desc_advance(do_mn, st * L::tile),
               desc_advance(q_mn, st * L::tile));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(dv);
      fence_regs<NO>(dk);
    } else if (pass) {
      named_arrive(2 - WG, kPair);
    }
  }

  if (!rows_in) return;
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (kpos[rr] >= p.sk) continue;
    const size_t row = (((size_t)b * p.sk + kpos[rr]) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dk_out + row + col) =
          pack_bf16(dk[4 * j + 2 * rr], dk[4 * j + 2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + row + col) =
          pack_bf16(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvRowsSmem<D>::threads, 1)
bwd_dkv_wgmma_rows(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap omap, BwdParams p,
                   int B) {
  using L = DkvRowsSmem<D>;
  constexpr int S = L::S;
  const int per_tile = p.hkv * B;
  const int n_kt = (p.sk + 2 * kBK - 1) / (2 * kBK);
  const int order = blockIdx.x / per_tile;
  const int kt = kRowsHeavyFirst ? order : n_kt - 1 - order;
  const int rest = blockIdx.x % per_tile;
  const int hk = rest % p.hkv, b = rest / p.hkv;
  const int rep = p.hq / p.hkv;
  const int tid = threadIdx.x;
  const int k0 = kt * 2 * kBK;
  const int qb0 = first_q_tile(p, k0);
  const int per_head = (p.sq + kBQ - 1) / kBQ - qb0;
  const int n_items = rep * per_head;
  const bool two = k0 + kBK < p.sk;  // the second 64 rows hold kv rows

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* q_s = smem + L::q;
  unsigned char* do_s = smem + L::dout;
  float* vec_s = reinterpret_cast<float*>(smem + L::vec);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvbar + 1;

  // item i (q head hk * rep + i / per_head, q tile qb0 + i % per_head)
  // into stage `slot` by warpgroup 1's thread t: thread 0 issues the TMA
  // of its Q and dO tiles, threads below kBQ copy row t of its vectors and
  // arrive once they land
  auto refill = [&](int i, int slot, int t) {
    const int h = hk * rep + i / per_head;
    const int q0 = (qb0 + i % per_head) * kBQ;
    mbar_expect_tx_if(t == 0, &full[slot], 2 * L::tile);
    tma_load_tile_if<D, kBQ>(t == 0, q_s + slot * L::tile, &qmap,
                             &full[slot], q0, h, b);
    tma_load_tile_if<D, kBQ>(t == 0, do_s + slot * L::tile, &omap,
                             &full[slot], q0, h, b);
    copy_vecs(t < kBQ, p, b, hk, rep, qb0, per_head, i, t,
              vec_s + slot * 3 * kBQ);
    cp_async_mbar_arrive_if(t < kBQ, &full[slot]);
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + kBQ);  // the TMA's bytes, kBQ copiers
    }
    mbar_fence_init();
  }
  __syncthreads();  // barriers initialised
  if (tid == 0) {  // K and V of the block's rows, once
    mbar_expect_tx(kvbar, (two ? 4 : 2) * L::tile);
    tma_load_tile<D, kBK>(smem + L::k, &kmap, kvbar, k0, hk, b);
    tma_load_tile<D, kBK>(smem + L::v, &vmap, kvbar, k0, hk, b);
    if (two) {
      tma_load_tile<D, kBK>(smem + L::k + L::tile, &kmap, kvbar, k0 + kBK,
                            hk, b);
      tma_load_tile<D, kBK>(smem + L::v + L::tile, &vmap, kvbar, k0 + kBK,
                            hk, b);
    }
  }

  if (tid < kWgThreads)  // warpgroup 0 fills the ring's first stages
    for (int s = 0; s < S && s < n_items; ++s) refill(s, s, tid);

  const int wg = tid / kWgThreads;
  if (wg == 0)
    dkv_rows<D, 0>(smem, p, b, hk, k0, qb0, per_head, n_items, refill);
  else
    dkv_rows<D, 1>(smem, p, b, hk, k0, qb0, per_head, n_items, refill);
}

// ---------------------------------------------------------------------
// K3 for Hopper, bf16: K2's loop with one more product. One warpgroup
// (128 threads) per (64-row q tile, q head, batch row); warp w owns q rows
// 16w..16w+15. Thread 0 loads the Q and dO tiles once by TMA and keeps
// kStages K/V tiles in flight through the mbarrier ring, from kv tile 0 up
// to the causal limit; lse (times log2(e)) and delta stay in registers, and
// the kv tile's segment ids are staged in shared memory one tile ahead.
// Per kv tile:
//   S = Q K^T and dP = dO V^T: wgmma, all four operands K-major as stored;
//   p = exp2(s scale log2(e) - lse log2(e)), zeroed for a masked pair
//     without taking its exp (masks tested only on tiles that cross the
//     causal limit, touch the sk edge, or carry segment ids), and
//     ds = p (dp - delta) scale, on the accumulator registers;
//   dQ += dS K: wgmma with dS rounded to bf16 in registers as the A
//     operand (as the TPU kernel rounds it) and K read MN-major through
//     the descriptor's transpose bit: no transposed copy of K.
// dQ stays in float32 registers. The grid runs q tiles heaviest first.
template <int D>
struct DqSmem {  // byte offsets into the 1024-aligned shared memory
  static constexpr int tile = 64 * D * 2;  // one [64][D] bf16 tile
  static constexpr int q = 0, dout = tile;
  static constexpr int k = 2 * tile;                 // kStages K tiles
  static constexpr int v = k + kStages * tile;       // kStages V tiles
  static constexpr int kseg = v + kStages * tile;    // [2][kBK] int
  static constexpr int bars = kseg + 2 * kBK * 4;    // Q/dO, then stages
  static constexpr int bytes = bars + (1 + kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap omap, BwdParams p, int B) {
  using L = DqSmem<D>;
  constexpr int NO = D / 2;  // dq accumulators per thread
  constexpr int KK = D / 16;
  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.hq * B));
  const int rest = blockIdx.x % (p.hq * B);
  const int h = rest % p.hq, b = rest / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ, offset = p.sk - p.sq;
  const float scale_log2 = p.scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* q_s = smem + L::q;
  unsigned char* do_s = smem + L::dout;
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  const int n_kb = kv_tiles(p, q0);
  auto load_kv = [&](int kb, int st) {  // thread 0
    mbar_expect_tx(&full[st], 2 * L::tile);
    tma_load_tile<D, kBK>(k_s + st * L::tile, &kmap, &full[st], kb * kBK, hk,
                          b);
    tma_load_tile<D, kBK>(v_s + st * L::tile, &vmap, &full[st], kb * kBK, hk,
                          b);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, 2 * L::tile);
    tma_load_tile<D, kBQ>(q_s, &qmap, qbar, q0, h, b);
    tma_load_tile<D, kBQ>(do_s, &omap, qbar, q0, h, b);
    for (int s = 0; s < kStages && s < n_kb; ++s) load_kv(s, s);
  }
  if (p.kseg != nullptr && tid < kBK)
    kseg_s[tid] = tid < p.sk ? p.kseg[(size_t)b * p.sk + tid] : 0;

  // this thread's two rows: q0 + 16 warp + g and 8 below
  int qpos[2], qs[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qpos[rr] = q0 + warp * 16 + g + 8 * rr;
    const bool in = qpos[rr] < p.sq;
    lse2[rr] = in ? p.lse[row_index(p, b, qpos[rr], h)] * kLog2e : 0.f;
    delta[rr] = in ? p.delta[row_index(p, b, qpos[rr], h)] : 0.f;
    qs[rr] = p.qseg != nullptr
                 ? p.qseg[(size_t)b * p.sq + min(qpos[rr], p.sq - 1)] : 0;
  }
  float acc[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  __syncthreads();  // barriers initialised, first segment ids staged
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages, k0 = kb * kBK;
    const unsigned char* kt = k_s + st * L::tile;
    const unsigned char* vt = v_s + st * L::tile;
    mbar_wait(&full[st], (kb / kStages) & 1);

    // S = Q K^T and dP = dO V^T
    wgmma_fence();
    fence_regs<32>(s);
    fence_regs<32>(dp);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(s, desc_kmajor<D, kBQ>(q_s, kk),
                   desc_kmajor<D, kBK>(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(dp, desc_kmajor<D, kBQ>(do_s, kk),
                   desc_kmajor<D, kBK>(vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // dS over S; rows past sq have q = do = 0, lse = delta = 0: ds = 0
    const bool need_mask = p.kseg != nullptr || k0 + kBK > p.sk ||
                           (p.causal && k0 + kBK - 1 > q0 + offset);
    const int* ks = kseg_s + (kb & 1) * kBK;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
          bool keep = true;
          if (need_mask) {
            const int kpos = k0 + c;
            keep = kpos < p.sk;
            if (p.causal) keep = keep && kpos <= qpos[rr] + offset;
            if (p.kseg != nullptr) keep = keep && ks[c] == qs[rr];
          }
          const float pr =
              keep ? exp2f(s[idx] * scale_log2 - lse2[rr]) : 0.f;
          s[idx] = pr * (dp[idx] - delta[rr]) * p.scale;
        }

    // dQ += dS K: dS from registers, K MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) wg_frag(a[t], s, t);
    wgmma_fence();
    fence_regs<NO>(acc);
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t)
      wgmma_rs<D>(acc, a[t], desc_mnmajor<D, kBK>(kt, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(acc);

    // the next tile's segment ids, then refill this stage
    if (p.kseg != nullptr && tid < kBK && kb + 1 < n_kb) {
      const int kpos = k0 + kBK + tid;
      kseg_s[((kb + 1) & 1) * kBK + tid] =
          kpos < p.sk ? p.kseg[(size_t)b * p.sk + kpos] : 0;
    }
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && kb + kStages < n_kb) load_kv(kb + kStages, st);
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qpos[rr] >= p.sq) continue;
    bf16* row = dq + row_index(p, b, qpos[rr], h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8 + tq * 2) =
          pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// ---------------------------------------------------------------------
// K3 for Hopper at D 256, bf16: bwd_dq_wgmma's tiles, loads and rounding
// with one block of two warpgroups and a producer warp (288 threads) per
// (64-row q tile, q head, batch row), in the manner of
// bwd_dkv_wgmma_pair. What held the one-warpgroup kernel back at this
// head dim: one block an SM (192 KB of tiles) whose one warpgroup ran
// every step in series (S and dP as 32 k16 steps, wait, the dS pass on
// 64 values a thread, dQ += dS K as 4 m64n256k16, wait, a block barrier,
// then thread 0's refill) with 128 float32 dQ accumulators a thread.
// Here, per kv tile:
//   warpgroup 0 runs S = Q K^T and warpgroup 1 dP = dO V^T, each over the
//     whole depth D, side by side;
//   warpgroup 0 forms p (masked as bwd_dq_wgmma does, a template per
//     case) and writes it in float32 to shared memory in the accumulator's
//     own per-thread order (thread t of one warpgroup holds the same (row,
//     column) positions as thread t of the other, so no swizzle is
//     involved): 16 KB;
//   warpgroup 1 reads it, forms dS = p (dP - delta) scale, and hands dS's
//     bf16 A fragments back the same way: 8 KB;
//   warpgroup w owns dQ's columns [128w, 128w + 128): dQ[:, cols] += dS
//     K[:, cols] (wgmma_rs<128>, K MN-major from column 128w), 64
//     accumulators a thread;
//   once both are done with the stage they arrive on named barrier 3, on
//     which the producer warp waits alone and refills the stage, its
//     lanes issuing the tile's TMA boxes side by side: no warpgroup waits
//     at the end of a tile or spends the TMA's issue there (a refill by
//     warpgroup 0's thread 0 after a barrier of both took about 950 of a
//     tile's 3,224 cycles: clock64 stamps, PERF.md).
// Named barriers 1 "p written" and 2 "dS written" order the exchange, 4
// warpgroup 0's staging of the next tile's segment ids before their use.
// Every load is predicated, never branched around: a branch that some
// threads of a warpgroup skip made ptxas serialise every wgmma of a
// function. p and dS are rounded where bwd_dq_wgmma rounds them, each
// product is the same wgmma on the same values, and each column's sum
// keeps its order of k16 steps, so dQ equals that kernel's bit for bit.
// Shared memory: bwd_dq_wgmma's 197,144 bytes and the 24 KB exchange,
// one block an SM.
__host__ __device__ constexpr bool dq_pair(int d) { return d == 256; }
constexpr int kDqPairThreads = 2 * kWgThreads + 32;  // and a producer warp

template <int D>
struct DqPairSmem : DqSmem<D> {  // DqSmem's tiles, then the exchange
  static constexpr int pt = (DqSmem<D>::bytes + 15) / 16 * 16;
  static constexpr int ds = pt + 32 * kWgThreads * 4;     // [32][128] float
  static constexpr int bytes = ds + 16 * kWgThreads * 4;  // [16][128] u32
};
static_assert(DqPairSmem<256>::bytes + kSmemSlack <= 232448,
              "K3's two-warpgroup shared memory");

// p = exp2(s scale log2(e) - lse log2(e)) on this thread's 32 accumulators
// of S (q rows qpos[0], qpos[1], kv columns k0 + 8j + 2tq + e), zeroed for
// a masked pair without taking its exp: bwd_dq_wgmma's expressions, with
// the mask chosen per tile by template
template <bool kMask>
__device__ __forceinline__ void probs_q(float* x, const BwdParams& p, int k0,
                                        const int* qpos, const int* qs,
                                        const int* ks, const float* lse2,
                                        int tq, float scale_log2) {
  const int offset = p.sk - p.sq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e, idx = 4 * j + 2 * rr + e;
        bool keep = true;
        if (kMask) {
          const int kpos = k0 + c;
          keep = kpos < p.sk;
          if (p.causal) keep = keep && kpos <= qpos[rr] + offset;
          if (p.kseg != nullptr) keep = keep && ks[c] == qs[rr];
        }
        x[idx] = keep ? exp2f(x[idx] * scale_log2 - lse2[rr]) : 0.f;
      }
}

// Warpgroup WG's half of bwd_dq_wgmma_pair's work. WG is a template
// parameter, so no branch or descriptor below depends on the warpgroup at
// run time.
template <int D, int WG>
__device__ __forceinline__ void dq_pair_cols(unsigned char* smem,
                                             const BwdParams& p, int b,
                                             int h, int q0, int n_kb) {
  using L = DqPairSmem<D>;
  constexpr int NC = D / 2;   // this warpgroup's columns of dq
  constexpr int NO = NC / 2;  // dq accumulators per thread
  constexpr int KK = D / 16;
  constexpr int kPair = 2 * kWgThreads;  // threads of a named barrier
  constexpr int col0 = WG * NC;
  const int t = threadIdx.x % kWgThreads;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tq = lane & 3;
  const float scale_log2 = p.scale * kLog2e;
  // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
  const unsigned char* a_s = smem + (WG == 0 ? L::q : L::dout);
  const unsigned char* b_s = smem + (WG == 0 ? L::k : L::v);
  const unsigned char* k_s = smem + L::k;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  float* pt_s = reinterpret_cast<float*>(smem + L::pt);
  uint32_t* ds_s = reinterpret_cast<uint32_t*>(smem + L::ds);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  // this thread's two rows: q0 + 16 warp + g and 8 below (loads clamped
  // in bounds and selected, not branched)
  int qpos[2], qs[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qpos[rr] = q0 + warp * 16 + g + 8 * rr;
    const bool in = qpos[rr] < p.sq;
    const size_t ri = row_index(p, b, min(qpos[rr], p.sq - 1), h);
    lse2[rr] = in ? p.lse[ri] * kLog2e : 0.f;
    delta[rr] = in ? p.delta[ri] : 0.f;
    qs[rr] = p.qseg != nullptr
                 ? p.qseg[(size_t)b * p.sq + min(qpos[rr], p.sq - 1)] : 0;
  }
  float acc[NO], x[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages, k0 = kb * kBK;
    const unsigned char* kt = k_s + st * L::tile;
    mbar_wait(&full[st], (kb / kStages) & 1);

    // x = S (warpgroup 0) or dP (warpgroup 1)
    const unsigned char* bt = b_s + st * L::tile;
    wgmma_fence();
    fence_regs<32>(x);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_ss<64>(x, desc_kmajor<D, kBQ>(a_s, kk),
                   desc_kmajor<D, kBK>(bt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(x);

    uint32_t da[4][4];  // A fragments of dS
    if (WG == 0) {  // p over S, to the other warpgroup; dS back
      const int* ks = kseg_s + (kb & 1) * kBK;
      if (p.kseg != nullptr || k0 + kBK > p.sk ||
          (p.causal && k0 + kBK - 1 > q0 + (p.sk - p.sq)))
        probs_q<true>(x, p, k0, qpos, qs, ks, lse2, tq, scale_log2);
      else
        probs_q<false>(x, p, k0, qpos, qs, ks, lse2, tq, scale_log2);
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) pt_s[idx * kWgThreads + t] = x[idx];
      named_arrive(1, kPair);
      named_sync(2, kPair);
#pragma unroll
      for (int j = 0; j < 16; ++j) da[j / 4][j % 4] = ds_s[j * kWgThreads + t];
    } else {  // dS over dP and the other warpgroup's p, and back
      named_sync(1, kPair);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * rr + e;
            x[idx] = pt_s[idx * kWgThreads + t] * (x[idx] - delta[rr]) *
                     p.scale;
          }
#pragma unroll
      for (int tt = 0; tt < kBK / 16; ++tt) wg_frag(da[tt], x, tt);
#pragma unroll
      for (int j = 0; j < 16; ++j) ds_s[j * kWgThreads + t] = da[j / 4][j % 4];
      named_arrive(2, kPair);
    }

    // dQ[:, cols] += dS K[:, cols]: dS from registers, K MN-major
    wgmma_fence();
    fence_regs<NO>(acc);
#pragma unroll
    for (int tt = 0; tt < kBK / 16; ++tt)
      wgmma_rs<NC>(acc, da[tt], desc_mnmajor<D, kBK>(kt, tt, col0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(acc);

    if (WG == 0) {  // the next tile's segment ids (threads t and t + 64
                    // write the same value), staged before any reads them
      if (p.kseg != nullptr && kb + 1 < n_kb) {
        const int kpos = k0 + kBK + (t & (kBK - 1));
        const int id = p.kseg[(size_t)b * p.sk + min(kpos, p.sk - 1)];
        kseg_s[((kb + 1) & 1) * kBK + (t & (kBK - 1))] =
            kpos < p.sk ? id : 0;
      }
      named_sync(4, kWgThreads);
    }
    named_arrive(3, kDqPairThreads);  // done with stage st
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qpos[rr] >= p.sq) continue;
    bf16* row = dq + row_index(p, b, qpos[rr], h) * D;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + col0 + j * 8 + tq * 2) =
          pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kDqPairThreads, 1)
bwd_dq_wgmma_pair(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap, BwdParams p,
                  int B) {
  using L = DqPairSmem<D>;
  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  // heaviest first: under causal masking the last q tiles see most kv
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.hq * B));
  const int rest = blockIdx.x % (p.hq * B);
  const int h = rest % p.hq, b = rest / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * kBQ;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  unsigned char* k_s = smem + L::k;
  unsigned char* v_s = smem + L::v;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kseg);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qbar + 1;

  const int n_kb = kv_tiles(p, q0);
  // kv tile kb into stage st where `on`, by the calling warp: lane c
  // loads K's box c, lane NB + c V's (the boxes issued side by side, not
  // one after another by one thread)
  constexpr int BC = swizzle_bytes(D) / 2, NB = D / BC;  // boxes a tile
  static_assert(2 * NB <= 32, "a lane a box");
  auto refill = [&](bool on, int kb, int st, int lane) {
    mbar_expect_tx_if(on && lane == 0, &full[st], 2 * L::tile);
    const bool is_v = lane >= NB;
    const int c = is_v ? lane - NB : lane;
    tma_load_4d_if(on && lane < 2 * NB,
                   (is_v ? v_s : k_s) + st * L::tile + c * kBK * BC * 2,
                   is_v ? &vmap : &kmap, &full[st], c * BC, hk, kb * kBK, b);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, 2 * L::tile);
    tma_load_tile<D, kBQ>(smem + L::q, &qmap, qbar, q0, h, b);
    tma_load_tile<D, kBQ>(smem + L::dout, &omap, qbar, q0, h, b);
  }
  if (tid < 32) {  // warp 0: the first stages
    __syncwarp();
    for (int s = 0; s < kStages && s < n_kb; ++s) refill(true, s, s, tid);
  }
  if (p.kseg != nullptr && tid < kBK)
    kseg_s[tid] = tid < p.sk ? p.kseg[(size_t)b * p.sk + tid] : 0;
  __syncthreads();  // barriers initialised, first segment ids staged

  if (tid < kWgThreads) {
    dq_pair_cols<D, 0>(smem, p, b, h, q0, n_kb);
  } else if (tid < 2 * kWgThreads) {
    dq_pair_cols<D, 1>(smem, p, b, h, q0, n_kb);
  } else {  // the producer warp: each tile's stage, once both warpgroups
            // are done with it
    for (int kb = 0; kb < n_kb; ++kb) {
      named_sync(3, kDqPairThreads);
      refill(kb + kStages < n_kb, kb + kStages, kb % kStages, tid % 32);
    }
  }
}

template <int D>
int launch_dq_wgmma(const BwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  int err = make_map(&qm, p.q, B, p.sq, p.hq, D, p.q_sb, p.q_ss, p.q_sh, kBQ);
  if (err == 0)
    err = make_map(&km, p.k, B, p.sk, p.hkv, D, p.k_sb, p.k_ss, p.k_sh, kBK);
  if (err == 0)
    err = make_map(&vm, p.v, B, p.sk, p.hkv, D, p.v_sb, p.v_ss, p.v_sh, kBK);
  if (err == 0)
    err = make_map(&om, p.dout, B, p.sq, p.hq, D, p.o_sb, p.o_ss, p.o_sh,
                   kBQ);
  if (err != 0) return err;
  const int blocks = (p.sq + kBQ - 1) / kBQ * p.hq * B;
  if constexpr (dq_pair(D)) {
    const int smem = DqPairSmem<D>::bytes + kSmemSlack;
    cudaFuncSetAttribute(bwd_dq_wgmma_pair<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    bwd_dq_wgmma_pair<D><<<blocks, kDqPairThreads, smem, stream>>>(
        qm, km, vm, om, p, B);
  } else {
    const int smem = DqSmem<D>::bytes + kSmemSlack;
    cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    bwd_dq_wgmma<D><<<blocks, kWgThreads, smem, stream>>>(qm, km, vm, om, p,
                                                          B);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const BwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap km, vm, qm, om;
  int err = make_map(&km, p.k, B, p.sk, p.hkv, D, p.k_sb, p.k_ss, p.k_sh, kBK);
  if (err == 0)
    err = make_map(&vm, p.v, B, p.sk, p.hkv, D, p.v_sb, p.v_ss, p.v_sh, kBK);
  if (err == 0)
    err = make_map(&qm, p.q, B, p.sq, p.hq, D, p.q_sb, p.q_ss, p.q_sh, kBQ);
  if (err == 0)
    err = make_map(&om, p.dout, B, p.sq, p.hq, D, p.o_sb, p.o_ss, p.o_sh,
                   kBQ);
  if (err != 0) return err;
  const int blocks = (p.sk + kBK - 1) / kBK * p.hkv * B;
  if constexpr (rows_design(D)) {
    const int smem = DkvRowsSmem<D>::bytes + kSmemSlack;
    cudaFuncSetAttribute(bwd_dkv_wgmma_rows<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int row_blocks = (p.sk + 2 * kBK - 1) / (2 * kBK) * p.hkv * B;
    bwd_dkv_wgmma_rows<D><<<row_blocks, DkvRowsSmem<D>::threads, smem,
                            stream>>>(km, vm, qm, om, p, B);
  } else if constexpr (D == 256) {
    const int smem = DkvPairSmem<D>::bytes + kSmemSlack;
    cudaFuncSetAttribute(bwd_dkv_wgmma_pair<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    bwd_dkv_wgmma_pair<D><<<blocks, 2 * kWgThreads, smem, stream>>>(
        km, vm, qm, om, p, B);
  } else {
    const int smem = DkvSmem<D>::bytes + kSmemSlack;
    cudaFuncSetAttribute(bwd_dkv_wgmma<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    bwd_dkv_wgmma<D><<<blocks, kWgThreads, smem, stream>>>(km, vm, qm, om, p,
                                                            B);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dq(int dtype, const BwdParams& p, int B, cudaStream_t s) {
  if (dtype == DTYPE_BF16) return launch_dq_wgmma<D>(p, B, s);
  using L = DqF32<D>;
  cudaFuncSetAttribute(bwd_dq_f32<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::bytes);
  const int blocks = (p.sq + L::BQ - 1) / L::BQ * p.hq * B;
  bwd_dq_f32<D><<<blocks, L::NT, L::bytes, s>>>(p, B);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(int dtype, const BwdParams& p, int B, cudaStream_t s) {
  if (dtype == DTYPE_BF16) return launch_dkv_wgmma<D>(p, B, s);
  using L = DkvF32<D>;
  cudaFuncSetAttribute(bwd_dkv_f32<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::bytes);
  const int blocks = (p.sk + L::BK - 1) / L::BK * p.hkv * B;
  bwd_dkv_f32<D><<<blocks, L::NT, L::bytes, s>>>(p, B);
  return (int)cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* qseg, const void* kseg, int sq, int sk,
                      int hq, int hkv, const long long* st, int causal,
                      float scale) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dq = p.dk = p.dv = nullptr;
  p.sq = sq; p.sk = sk; p.hq = hq; p.hkv = hkv;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.causal = causal;
  p.scale = scale;
  p.vec16 = rows_16b(q, 4, st[0], st[1], st[2]) &&
            rows_16b(k, 4, st[3], st[4], st[5]) &&
            rows_16b(v, 4, st[6], st[7], st[8]) &&
            rows_16b(dout, 4, st[9], st[10], st[11]);
  return p;
}

bool valid_dtype(int dtype) {
  return dtype == DTYPE_BF16 || dtype == DTYPE_F32;
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and do.
// Head dims: HEAD_DIM_CASES (common.cuh; the wrapper refuses others).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, const void* qseg,
                            const void* kseg, void* dq_out, int B, int sq,
                            int sk, int hq, int hkv, int d,
                            const long long* strides, int causal, float scale,
                            void* stream) {
  if (!valid_dtype(dtype)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, qseg, kseg, sq, sk, hq,
                            hkv, strides, causal, scale);
  p.dq = dq_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(D) dq<D>(dtype, p, B, s)
  switch (d) {
    HEAD_DIM_CASES(DQ)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, const void* qseg,
                             const void* kseg, void* dk_out, void* dv_out,
                             int B, int sq, int sk, int hq, int hkv, int d,
                             const long long* strides, int causal,
                             float scale, void* stream) {
  if (!valid_dtype(dtype)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, qseg, kseg, sq, sk, hq,
                            hkv, strides, causal, scale);
  p.dk = dk_out;
  p.dv = dv_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(D) dkv<D>(dtype, p, B, s)
  switch (d) {
    HEAD_DIM_CASES(DKV)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DKV
}
