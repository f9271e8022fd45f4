// K1: single-token decode attention over the paged KV pool.
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_decode_kernel
// (pl.pallas_call in _decode_call). It computes, for each sequence b and
// query head hq, softmax(q . K^T * scale) . V over the first lengths[b]
// rows of the sequence's pages, with the pool laid out
// [P, Hkv, page, 2*D] (K in lanes [:D], V in lanes [D:]). Rows at or past
// the length never enter a product (a recycled pool may hold NaN), p is
// rounded to the kv type before p . V as the TPU kernel rounds it, and a
// sequence of length 0 gives zeros.
//
// What bounds it on the H100: bytes. Each K/V row is read once and used
// for 2*rep*D multiply-adds (rep = Hq/Hkv, 4 for Llama-3-8B), about two
// operations per byte, far below the ~295 the card needs to be bound by
// arithmetic. So the design keeps bytes in flight on many SMs and reads
// every live page once and nothing else:
//   - split-KV (flash-decoding): one block per (kv head, sequence, split
//     of split_pages_for(page) pages, about 64 rows), so the longest
//     sequence spreads over many SMs; the grid is fixed by the block
//     table's width (lengths live on the device: no host sync), blocks
//     past a sequence's end exit at once, and a second small kernel
//     merges the live splits' partial (m, l, acc) by their log-sum-exp,
//     reading the lengths to skip the dead ones;
//   - bf16 (paged_decode_mma, head dims 16, 32, 64, 96, 128 and 256: a
//     k16 step of S and an m16 tile of O^T per 16 dims), one warp per
//     block: a page of one kv head is contiguous (page * 2D elements) and
//     its live rows go to a slot of a ring of ring_slots_for(...) >= 3 page
//     slots by the 1-d bulk copy (hopper.cuh's bulk_load, no tensor map;
//     page ids read from the block table in the kernel), one copy per row,
//     started by the warp's lanes together, so that each row lands kRowPad
//     bytes after the previous one: 8 rows of one column then fall in 8
//     different banks for ldmatrix (a page copied whole puts them 8-way in
//     one). Rows at or past the length are not copied. Slots complete on
//     mbarriers and are refilled as soon as the warp is done with their
//     page, so the next pages are in flight during the math;
//   - up to 8 q heads of the kv head share every K/V row on the tensor
//     cores (mma.sync m16n8k16, ldmatrix from the page slots), with the q
//     heads as the narrow dimension: S [heads x 16 rows] = q K^T (heads
//     padded to the 16 rows of A) and O^T [D x heads] += V^T P^T, whose B
//     fragment is S's accumulator rounded to bf16 (no shuffle, no shared
//     memory); the online softmax runs in base 2 on the accumulators. A kv
//     head with more than 8 q heads (rep > 8) takes one block per group of
//     8, each reading the split's pages (the second read mostly from L2);
//   - a row at or past the length (the uncopied tail of the last page, or
//     a 16-row step past the split's rows) is read from a zero row in
//     shared memory instead of its slot, and its score is masked, so no
//     stale byte reaches a product;
//   - float32 (the exact reference path of the tests) keeps the scalar
//     kernel: 256 threads stage 64-row chunks by 16-byte loads and run
//     the products on the CUDA cores.
// At D 96 (Phi-3-mini's 32/32 heads) bf16 takes paged_decode_mha: four
// warps a block share each split's pages and steps (see there).
// Not done yet: that design at the other head dims; a merge folded into
// the last split by an atomic count (one launch fewer: measured slower
// than the merge kernel in every design that tried it, PERF.md PR 18);
// the products of rep 1 on the CUDA cores instead of an mma whose A holds
// one live q head of 16 rows.
// The wrapper guarantees 2*D*sizeof(T) is a multiple of 16 bytes and a
// 16-byte aligned pool.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;    // scalar (float32) kernel
constexpr int kChunkRows = 64;   // scalar kernel: kv rows staged per pass
constexpr int kSplitRows = 64;  // kv rows per block, about (whole pages)
constexpr int kMinSplitPages = 4;
constexpr int kRingBytes = 32 * 1024;  // bf16 kernel: page slots' budget
constexpr int kMinSlots = 3;
constexpr int kRowPad = 16;  // bytes after each row in a slot (no conflicts)
constexpr int kGroupHeads = 8;  // bf16 kernel: q heads per block (mma's n8)
constexpr int kMergeThreads = 128;
using bf16 = __nv_bfloat16;

// floats of shared memory before the staged kv tile, rounded up to a
// 16-byte boundary
__host__ __device__ inline int float_words(int rep, int d, int ch) {
  return (2 * rep * d + rep * ch + 3 * rep + 3) / 4 * 4;
}

inline int chunk_pages_for(int page) { return max(1, kChunkRows / page); }

// pages per split: at least kMinSplitPages and about kSplitRows rows, in
// whole chunks of the scalar kernel
inline int split_pages_for(int page) {
  const int c = chunk_pages_for(page);
  const int sp = max(kMinSplitPages, (kSplitRows + page - 1) / page);
  return (sp + c - 1) / c * c;
}

// page slots of the bf16 kernel's ring: kRingBytes' worth, at least
// kMinSlots (a 16-row step spans at most two pages of 8 rows or more, and
// the next page is in flight), at most the split's pages. At D 256 a row
// is 1,040 bytes with its pad, so pages of 8, 16 and 32 rows all take
// kMinSlots: 25,984, 50,944 and 100,864 bytes of ring, far inside the
// 232,448 that launch_mma checks
inline int ring_slots_for(int page, int d) {
  const int page_bytes = page * (2 * d * (int)sizeof(bf16) + kRowPad);
  return min(split_pages_for(page), max(kMinSlots, kRingBytes / page_bytes));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,       // [B, Hq, D]
                    const T* __restrict__ pool,    // [P, Hkv, page, 2D]
                    const int* __restrict__ bt,    // [B, MP]
                    const int* __restrict__ lens,  // [B]
                    float* __restrict__ part_acc,  // [B, Hq, splits, D]
                    float* __restrict__ part_ml,   // [B, Hq, splits, 2]
                    int hq, int hkv, int d, int page, int mp,
                    int chunk_pages, int split_pages, float scale) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // sequence
  const int split = blockIdx.z, n_split = gridDim.z;
  const int rep = hq / hkv;
  const int ch = chunk_pages * page;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [rep][d]
  float* acc = q_s + rep * d;      // [rep][d]
  float* p_s = acc + rep * d;      // [rep][ch] scores, then probabilities
  float* m_s = p_s + rep * ch;     // [rep]
  float* l_s = m_s + rep;          // [rep]
  float* a_s = l_s + rep;          // [rep] rescale factor of this chunk
  // [ch][2d], 16-byte aligned (launch pads the float part to 4 floats)
  T* kv_s = reinterpret_cast<T*>(smem + float_words(rep, d, ch));

  const int len = min(lens[b], mp * page);  // a block table bounds a sequence
  if (split * split_pages * page >= len) return;  // past the end: no work
  const size_t q_base = ((size_t)b * hq + (size_t)h * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = NEG_INF_F;
    l_s[r] = 0.f;
  }
  const int p_begin = split * split_pages;  // this block's pages
  const int p_end = min((len + page - 1) / page, p_begin + split_pages);
  const int d2 = 2 * d;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  const int page_vecs = page * d2 / kVec;    // vectors per page of a head
  const int n_vec = chunk_pages * page_vecs;
  __syncthreads();

  for (int c0 = p_begin; c0 < p_end; c0 += chunk_pages) {
    const int row0 = c0 * page;  // absolute position of the chunk's row 0
    // stage the chunk with 16-byte loads: a page of one kv head is
    // contiguous (page * 2D elements), a vector never straddles a row,
    // and rows past len are zeros, never loaded
#pragma unroll 4
    for (int i = tid; i < n_vec; i += kThreads) {
      const int pj = i / page_vecs, w = i - pj * page_vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + pj * page + (w * kVec) / d2 < len) {
        const int p = bt[(size_t)b * mp + c0 + pj];
        val = reinterpret_cast<const uint4*>(
            pool + ((size_t)p * hkv + h) * page * d2)[w];
      }
      reinterpret_cast<uint4*>(kv_s)[i] = val;
    }
    __syncthreads();

    // scores: one warp per kv row, lanes split the head dim
    for (int j = warp; j < ch; j += n_warps) {
      const bool live = row0 + j < len;
      const T* k_row = kv_s + (size_t)j * d2;
      for (int r = 0; r < rep; ++r) {
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part = fmaf(q_s[r * d + e], to_f32(k_row[e]), part);
        part = group_sum<32>(part);
        if (lane == 0) p_s[r * ch + j] = live ? part * scale : NEG_INF_F;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int r = warp; r < rep; r += n_warps) {
      float mx = NEG_INF_F;
      for (int j = lane; j < ch; j += 32) mx = fmaxf(mx, p_s[r * ch + j]);
      mx = group_max<32>(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < ch; j += 32) {
        const float p =
            row0 + j < len ? expf(p_s[r * ch + j] - m_new) : 0.f;
        p_s[r * ch + j] = p;
        sum += p;
      }
      sum = group_sum<32>(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V; each thread owns (head, lane-of-d) cells
    for (int i = tid; i < rep * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      const float* p = p_s + r * ch;
      const T* v_col = kv_s + d + e;
      float a = acc[i] * a_s[r];
      for (int j = 0; j < ch; ++j)
        a = fmaf(p[j], to_f32(v_col[(size_t)j * d2]), a);
      acc[i] = a;
    }
    __syncthreads();
  }

  // partial results of this split
  const size_t part = ((size_t)b * hq + (size_t)h * rep) * n_split + split;
  for (int i = tid; i < rep * d; i += kThreads) {
    const int r = i / d, e = i - r * d;
    part_acc[(part + (size_t)r * n_split) * d + e] = acc[i];
  }
  for (int r = tid; r < rep; r += kThreads) {
    part_ml[(part + (size_t)r * n_split) * 2] = m_s[r];
    part_ml[(part + (size_t)r * n_split) * 2 + 1] = l_s[r];
  }
}

// ---------------------------------------------------------------------
// bf16 for Hopper: one warp per (kv head and group of kGroupHeads of its q
// heads, sequence, split). Lane (g, t) = (lane / 4, lane % 4) in
// mma.sync's fragment layouts.

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (.trans: each thread gets a column pair instead of a row pair)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The split walks its live rows in steps of 16. Per step, lane l points
// ldmatrix at row (l % 8) + 8 (l / 16), columns + 8 ((l / 8) % 2), of the
// step; with that one address
//   ldsm_x4 at column 16 kk of K gives the B fragments of S = q K^T for
//     the step's two n8 tiles (rows 0-7, 8-15), k16 step kk;
//   ldsm_x4_trans at column 16 dt of V gives the A fragment of
//     O^T += V^T P^T for output rows (head dims) 16 dt .. 16 dt + 15.
// S's accumulator c[0..1] of n8 tile j is p of the group's q head g at
// step rows 8 j + 2 t, + 1: packed to bf16 it is the B fragment of P^T
// (b0 from tile 0, b1 from tile 1). O^T's accumulator holds head dims
// 16 dt + g (+ 8) of the group's q heads 2 t, 2 t + 1.
// decode_step is one warp's step r0 of a split's `rows` live rows: lane
// l's address `addr` as above (a zero row past `rows`); the online softmax
// of head g keeps (m, l) in base 2.
template <int D>
__device__ __forceinline__ void decode_step(float (*acc)[4], float& m,
                                            float& l,
                                            const uint32_t (*qa)[2],
                                            uint32_t addr, int r0, int rows,
                                            int lane, float scale_log2) {
  const int t = lane & 3;
  // S = q K^T: heads g (and g + 8, zero) x the step's 16 rows
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4];
    ldsm_x4(kf, addr + 32 * kk);
    const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
    mma_bf16(s[0], a, kf[0], kf[1]);
    mma_bf16(s[1], a, kf[2], kf[3]);
  }

  // online softmax of head g over rows 8 j + 2 t + e
  float mx = NEG_INF_F;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = r0 + 8 * j + 2 * t + e < rows;
      s[j][e] = live ? s[j][e] * scale_log2 : NEG_INF_F;
      mx = fmaxf(mx, s[j][e]);
    }
  mx = group_max<4>(mx);  // finite: row r0 is live
  const float m_new = fmaxf(m, mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = s[j][e] == NEG_INF_F ? 0.f : exp2f(s[j][e] - m_new);
      sum += s[j][e];
    }
  sum = group_sum<4>(sum);
  const float alpha = exp2f(m - m_new);
  l = l * alpha + sum;
  m = m_new;
  // O^T's columns are heads 2 t, 2 t + 1: their rescale factors
  const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
  const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);

  // O^T += V^T P^T, P rounded to bf16
  const uint32_t pb0 = pack_bf16(s[0][0], s[0][1]);
  const uint32_t pb1 = pack_bf16(s[1][0], s[1][1]);
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    uint32_t vf[4];
    ldsm_x4_trans(vf, addr + D * 2 + 32 * dt);
    acc[dt][0] *= a0;
    acc[dt][1] *= a1;
    acc[dt][2] *= a0;
    acc[dt][3] *= a1;
    mma_bf16(acc[dt], vf, pb0, pb1);
  }
}

template <int D>
__global__ void __launch_bounds__(32)
paged_decode_mma(const bf16* __restrict__ q,       // [B, Hq, D]
                 const bf16* __restrict__ pool,    // [P, Hkv, page, 2D]
                 const int* __restrict__ bt,       // [B, MP]
                 const int* __restrict__ lens,     // [B]
                 float* __restrict__ part_acc,     // [B, Hq, splits, D]
                 float* __restrict__ part_ml,      // [B, Hq, splits, 2]
                 int hq, int hkv, int page, int mp, int split_pages,
                 int n_slots, float scale_log2) {
  constexpr int RB = 2 * D * 2;  // bytes of a pool row (K | V)
  const int rep = hq / hkv, groups = (rep + kGroupHeads - 1) / kGroupHeads;
  const int h = blockIdx.x / groups, b = blockIdx.y;
  // the group's first q head and its number of heads
  const int head0 = h * rep + blockIdx.x % groups * kGroupHeads;
  const int n_heads = min(kGroupHeads, h * rep + rep - head0);
  const int split = blockIdx.z, n_split = gridDim.z;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int len = min(lens[b], mp * page);  // a block table bounds a sequence
  const int p_begin = split * split_pages;
  const int n_pages = min((len + page - 1) / page - p_begin, split_pages);
  if (n_pages <= 0) return;  // past the sequence's end: no work
  const int rows = min(len - p_begin * page, split_pages * page);  // live
  constexpr int RS = RB + kRowPad;  // a row's stride in a slot
  const int page_bytes = page * RS;

  // [n_slots][page][RS] page slots, a zero row, n_slots barriers
  extern __shared__ __align__(16) unsigned char ring_raw[];
  unsigned char* smem = ring_raw;
  unsigned char* zero_row = smem + n_slots * page_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_row + RB);
  const bf16* pool_h = pool + (size_t)h * page * 2 * D;
  const size_t pool_page = (size_t)hkv * page * 2 * D;  // elements
  const int* pages = bt + (size_t)b * mp + p_begin;
  auto load_page = [&](int i) {  // every lane: page i's live rows, one each
    const int n = min(page, rows - i * page);
    uint64_t* bar = &full[i % n_slots];
    if (lane == 0) mbar_expect_tx(bar, n * RB);
    __syncwarp();
    const bf16* src = pool_h + (size_t)pages[i] * pool_page;
    unsigned char* dst = smem + (i % n_slots) * page_bytes;
    for (int r = lane; r < n; r += 32)
      bulk_load(dst + r * RS, src + (size_t)r * 2 * D, RB, bar);
  };
  if (lane == 0) {
    for (int s = 0; s < n_slots; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncwarp();
  for (int i = 0; i < n_slots && i < n_pages; ++i) load_page(i);
  int freed = 0;  // pages whose slot has been handed on
  for (int i = lane; i < RB / 16; i += 32)
    reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0u, 0u, 0u, 0u);

  // the group's q heads g (< n_heads) as the A operand, rows g + 8 zero
  uint32_t qa[D / 16][2];
  const bf16* q_row =
      q + ((size_t)b * hq + head0 + min(g, n_heads - 1)) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = g < n_heads ? *reinterpret_cast<const uint32_t*>(
                                  q_row + 16 * kk + 2 * t) : 0u;
    qa[kk][1] = g < n_heads ? *reinterpret_cast<const uint32_t*>(
                                  q_row + 16 * kk + 2 * t + 8) : 0u;
  }
  float acc[D / 16][4];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m = NEG_INF_F, l = 0.f;  // of q head g, in base 2
  __syncwarp();  // barriers initialised, zero row written

  const int lrow = (lane & 7) + 8 * (lane >> 4);
  const int lcol = 16 * ((lane >> 3) & 1);  // bytes
  for (int r0 = 0; r0 < rows; r0 += 16) {
    const int last = min(r0 + 15, rows - 1) / page;
    for (int i = r0 / page; i <= last; ++i)
      mbar_wait(&full[i % n_slots], (i / n_slots) & 1);
    const int row = r0 + lrow;
    const unsigned char* rp =
        row < rows ? smem + ((row / page) % n_slots) * page_bytes +
                         (row % page) * RS
                   : zero_row;
    decode_step<D>(acc, m, l, qa, smem_addr(rp) + lcol, r0, rows, lane,
                   scale_log2);

    // hand on the slots of the pages this step finished
    __syncwarp();
    const int done = min((r0 + 16) / page, n_pages);
    for (; freed < done; ++freed)
      if (freed + n_slots < n_pages) load_page(freed + n_slots);
  }

  // partial results of this split: acc unnormalised, (m, l) in base e
  const size_t part = ((size_t)b * hq + head0) * n_split + split;
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int head = 2 * t + (c & 1), e = 16 * dt + g + 8 * (c >> 1);
      if (head < n_heads)
        part_acc[(part + (size_t)head * n_split) * D + e] = acc[dt][c];
    }
  if (t == 0 && g < n_heads) {
    part_ml[(part + (size_t)g * n_split) * 2] = m * kLn2;
    part_ml[(part + (size_t)g * n_split) * 2 + 1] = l;
  }
}

// Merge the live splits of each (sequence, q head): out = sum_s acc_s
// e^(m_s-M) / sum_s l_s e^(m_s-M), M = max_s m_s; zeros for length 0.
// A split is live if it holds a row below the length (every live split
// saw at least one row, so its l > 0); the dead ones wrote nothing. The
// first warp turns the live splits' (m, l) into weights in shared memory,
// then every thread sums its output columns over the splits.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lens, T* __restrict__ out,
                          int hq, int d, int n_split, int split_rows,
                          int max_len) {
  extern __shared__ float w_s[];  // [n_split]
  const size_t row = blockIdx.x;  // b * Hq + q head
  const int len = min(lens[row / hq], max_len);
  const int live = min(n_split, (len + split_rows - 1) / split_rows);
  const float* ml = part_ml + row * n_split * 2;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = NEG_INF_F;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, ml[2 * s]);
    mx = group_max<32>(mx);
    float denom = 0.f;
    for (int s = lane; s < live; s += 32)
      denom += ml[2 * s + 1] * expf(ml[2 * s] - mx);
    denom = group_sum<32>(denom);
    for (int s = lane; s < live; s += 32)
      w_s[s] = expf(ml[2 * s] - mx) / denom;
  }
  __syncthreads();
  const float* acc = part_acc + row * n_split * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) num += w_s[s] * acc[(size_t)s * d + e];
    out[row * d + e] = from_f32<T>(num);
  }
}

// ---------------------------------------------------------------------
// bf16 at D 96 (Phi-3-mini's 32/32 heads): paged_decode_mha, kMhaWarps
// warps a block sharing one split of (kv head and group blockIdx.x,
// sequence blockIdx.y), split blockIdx.z: paged_decode_mma's grid and
// partials, its merge kernel after it. What held paged_decode_mma back
// there: one warp walked its split's ~64 rows in four 16-row steps one
// after another (at rep 1 each step's mma carries one live q head), and
// its ring held the split's pages until the last step. Here:
//   - the split's pages all land at once in the block's slots (the whole
//     split fits: 25,600 bytes at pages of 8 and 16, 51,200 at 32), each
//     page on its own mbarrier, the block's threads issuing one row copy
//     each (paged_decode_mma's bulk copies into padded rows);
//   - warp w takes steps w, w + kMhaWarps, ... (decode_step, so each step
//     is paged_decode_mma's arithmetic) and waits only for their pages:
//     at pages of 16 one step, one page a warp;
//   - the warps' (m, l, O^T) meet in shared memory over the slots and are
//     combined by their log-sum-exp into the split's one partial.
// Designs measured against it and left out of the tree (PERF.md, PR 18):
// blocks that walk only the live splits (one or two page buffers), the
// merge folded into the last live split by an atomic count (in this
// design and in those), one split a warp with four warps a block, and two
// or eight warps a split.
constexpr int kMhaWarps = 4;
// the head dims that take this design (bf16)
__host__ __device__ constexpr bool mha_design(int d) { return d == 96; }

// the block's shared memory: the split's page slots (which the warps' O^T
// reuse), a zero row, a barrier a page
inline int mha_slot_bytes(int page, int d, int split_pages) {
  const int pages = split_pages * page * (4 * d + kRowPad);
  return (max(pages, kMhaWarps * kGroupHeads * d * 4) + 15) / 16 * 16;
}

template <int D>
__global__ void __launch_bounds__(32 * kMhaWarps)
paged_decode_mha(const bf16* __restrict__ q,       // [B, Hq, D]
                 const bf16* __restrict__ pool,    // [P, Hkv, page, 2D]
                 const int* __restrict__ bt,       // [B, MP]
                 const int* __restrict__ lens,     // [B]
                 float* __restrict__ part_acc,     // [B, Hq, splits, D]
                 float* __restrict__ part_ml,      // [B, Hq, splits, 2]
                 int hq, int hkv, int page, int mp, int split_pages,
                 int slot_bytes, float scale_log2) {
  constexpr int RB = 2 * D * 2;     // bytes of a pool row (K | V)
  constexpr int RS = RB + kRowPad;  // a row's stride in a slot
  constexpr int NT = 32 * kMhaWarps;
  const int rep = hq / hkv, groups = (rep + kGroupHeads - 1) / kGroupHeads;
  const int h = blockIdx.x / groups, b = blockIdx.y;
  // the group's first q head and its number of heads
  const int head0 = h * rep + blockIdx.x % groups * kGroupHeads;
  const int n_heads = min(kGroupHeads, h * rep + rep - head0);
  const int split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(lens[b], mp * page);  // a block table bounds a sequence
  const int p_begin = split * split_pages;
  const int n_pages = min((len + page - 1) / page - p_begin, split_pages);
  if (n_pages <= 0) return;  // past the sequence's end: no work
  const int rows = min(len - p_begin * page, split_pages * page);  // live
  const int page_bytes = page * RS;

  // [split_pages][page][RS] page slots, then the warps' O^T; a zero row;
  // a barrier a page
  extern __shared__ __align__(16) unsigned char slots[];
  unsigned char* zero_row = slots + slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_row + RB);
  float* o_s = reinterpret_cast<float*>(slots);  // [warps][group][D]
  __shared__ float ml_s[kMhaWarps][kGroupHeads][2];  // a warp's (m, l)
  const bf16* pool_h = pool + (size_t)h * page * 2 * D;
  const size_t pool_page = (size_t)hkv * page * 2 * D;  // elements
  const int* pages = bt + (size_t)b * mp + p_begin;
  if (tid < n_pages) {  // page tid's barrier, armed with its live rows
    mbar_init(&full[tid], 1);
    mbar_fence_init();
    mbar_expect_tx(&full[tid], min(page, rows - tid * page) * RB);
  }
  for (int i = tid; i < RB / 16; i += NT)
    reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int r = tid; r < rows; r += NT)  // every live row, one copy each
    bulk_load(slots + (r / page) * page_bytes + (r % page) * RS,
              pool_h + (size_t)pages[r / page] * pool_page +
                  (size_t)(r % page) * 2 * D,
              RB, &full[r / page]);

  // the group's q heads g (< n_heads) as the A operand, rows g + 8 zero
  uint32_t qa[D / 16][2];
  const bf16* q_row =
      q + ((size_t)b * hq + head0 + min(g, n_heads - 1)) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = g < n_heads ? *reinterpret_cast<const uint32_t*>(
                                  q_row + 16 * kk + 2 * t) : 0u;
    qa[kk][1] = g < n_heads ? *reinterpret_cast<const uint32_t*>(
                                  q_row + 16 * kk + 2 * t + 8) : 0u;
  }
  float acc[D / 16][4];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m = NEG_INF_F, l = 0.f;  // of q head g, in base 2
  const int lrow = (lane & 7) + 8 * (lane >> 4);
  const int lcol = 16 * ((lane >> 3) & 1);  // bytes
  for (int r0 = 16 * warp; r0 < rows; r0 += 16 * kMhaWarps) {
    const int last = min(r0 + 15, rows - 1) / page;
    for (int i = r0 / page; i <= last; ++i) mbar_wait(&full[i], 0);
    const int row = r0 + lrow;
    const unsigned char* rp =
        row < rows ? slots + (row / page) * page_bytes + (row % page) * RS
                   : zero_row;
    decode_step<D>(acc, m, l, qa, smem_addr(rp) + lcol, r0, rows, lane,
                   scale_log2);
  }
  // every live row is in some step, so every copy has landed once every
  // warp is past here: the slots take the warps' O^T
  __syncthreads();
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int head = 2 * t + (c & 1), e = 16 * dt + g + 8 * (c >> 1);
      o_s[(warp * kGroupHeads + head) * D + e] = acc[dt][c];
    }
  if (t == 0) {
    ml_s[warp][g][0] = m;
    ml_s[warp][g][1] = l;
  }
  __syncthreads();
  // the split's partial (a warp without a step has m = NEG_INF_F, l = 0:
  // weight 0): acc unnormalised, (m, l) in base e
  const size_t part = ((size_t)b * hq + head0) * n_split + split;
  for (int i = tid; i < n_heads * D; i += NT) {
    const int hh = i / D, e = i % D;
    float mw = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < kMhaWarps; ++w) mw = fmaxf(mw, ml_s[w][hh][0]);
    float lw = 0.f, aw = 0.f;
#pragma unroll
    for (int w = 0; w < kMhaWarps; ++w) {
      const float wt = exp2f(ml_s[w][hh][0] - mw);
      lw += ml_s[w][hh][1] * wt;
      aw += o_s[(w * kGroupHeads + hh) * D + e] * wt;
    }
    const size_t idx = part + (size_t)hh * n_split;
    part_acc[idx * D + e] = aw;
    if (e == 0) {
      part_ml[idx * 2] = mw * kLn2;
      part_ml[idx * 2 + 1] = lw;
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* pool, const void* bt,
               const void* lens, void* part_acc, void* part_ml, int B,
               int hq, int hkv, int page, int mp, int n_split, float scale,
               cudaStream_t stream) {
  const int rep = hq / hkv;
  dim3 grid(hkv * ((rep + kGroupHeads - 1) / kGroupHeads), B, n_split);
  if constexpr (mha_design(D)) {
    const int sp = split_pages_for(page);
    const int slot_bytes = mha_slot_bytes(page, D, sp);
    const int smem = slot_bytes + 4 * D + sp * 8;
    if (smem > 232448 - 1024)  // 1 KB of static shared memory
      return (int)cudaErrorInvalidValue;  // page too large
    cudaFuncSetAttribute(paged_decode_mha<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    paged_decode_mha<D><<<grid, 32 * kMhaWarps, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
        static_cast<const int*>(bt), static_cast<const int*>(lens),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml), hq,
        hkv, page, mp, sp, slot_bytes, scale * kLog2e);
    return (int)cudaGetLastError();
  }
  const int slots = ring_slots_for(page, D);
  const int smem = slots * page * (4 * D + kRowPad) + 4 * D + slots * 8;
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // page too large
  cudaFuncSetAttribute(paged_decode_mma<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  paged_decode_mma<D><<<grid, 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
      static_cast<const int*>(bt), static_cast<const int*>(lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), hq, hkv,
      page, mp, split_pages_for(page), slots, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_bf16(int d, const void* q, const void* pool, const void* bt,
                const void* lens, void* part_acc, void* part_ml, int B,
                int hq, int hkv, int page, int mp, int n_split, float scale,
                cudaStream_t stream) {
#define MMA(D)                                                             \
  launch_mma<D>(q, pool, bt, lens, part_acc, part_ml, B, hq, hkv, page, mp, \
                n_split, scale, stream)
  switch (d) {
    HEAD_DIM_CASES(MMA)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMA
}

int launch_f32(const void* q, const void* pool, const void* bt,
               const void* lens, void* part_acc, void* part_ml, int B,
               int hq, int hkv, int d, int page, int mp, int n_split,
               float scale, cudaStream_t stream) {
  const int rep = hq / hkv;
  const int chunk_pages = chunk_pages_for(page);
  const int ch = chunk_pages * page;
  const size_t smem = sizeof(float) * float_words(rep, d, ch) +
                      sizeof(float) * (size_t)ch * 2 * d;
  cudaFuncSetAttribute(paged_decode_kernel<float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(hkv, B, n_split);
  paged_decode_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool),
      static_cast<const int*>(bt), static_cast<const int*>(lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), hq, hkv,
      d, page, mp, chunk_pages, split_pages_for(page), scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits a block table of mp pages takes (the wrapper sizes the partial
// buffers with it: acc [B, Hq, splits, D] and (m, l) [B, Hq, splits, 2],
// float32).
extern "C" int paged_decode_splits(int page, int mp) {
  const int sp = split_pages_for(page);
  return (mp + sp - 1) / sp;
}

// Whether paged_decode takes this type and head dim: bf16 takes
// HEAD_DIM_CASES (common.cuh: the tensor-core kernel's instances), float32
// any D whose pool row is a multiple of 16 bytes (the wrapper checks the
// row).
extern "C" int paged_decode_supports(int dtype, int d) {
#define YES(D) 1
  if (dtype == DTYPE_BF16) switch (d) {
      HEAD_DIM_CASES(YES)
      default: return 0;
    }
#undef YES
  return dtype == DTYPE_F32;
}

extern "C" int paged_decode(int dtype, const void* q, const void* pool,
                            const void* bt, const void* lens, void* part_acc,
                            void* part_ml, void* out, int B, int hq, int hkv,
                            int d, int page, int mp, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_split = paged_decode_splits(page, mp);
  if (!paged_decode_supports(dtype, d)) return (int)cudaErrorInvalidValue;
  const int err =
      dtype == DTYPE_F32
          ? launch_f32(q, pool, bt, lens, part_acc, part_ml, B, hq, hkv, d,
                       page, mp, n_split, scale, s)
          : launch_bf16(d, q, pool, bt, lens, part_acc, part_ml, B, hq, hkv,
                        page, mp, n_split, scale, s);
  if (err != 0) return err;
  const dim3 grid(B * hq), block(kMergeThreads);
  const int split_rows = split_pages_for(page) * page;
  const size_t w_bytes = sizeof(float) * n_split;
  if (dtype == DTYPE_BF16)
    paged_decode_merge_kernel<bf16><<<grid, block, w_bytes, s>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<const int*>(lens),
        static_cast<bf16*>(out), hq, d, n_split, split_rows, mp * page);
  else
    paged_decode_merge_kernel<float><<<grid, block, w_bytes, s>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<const int*>(lens),
        static_cast<float*>(out), hq, d, n_split, split_rows, mp * page);
  return (int)cudaGetLastError();
}
