// K1: single-token decode attention over the paged KV pool.
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_decode_kernel
// (pl.pallas_call in _decode_call). It computes, for each sequence b and
// query head hq, softmax(q . K^T * scale) . V over the first lengths[b]
// rows of the sequence's pages, with the pool laid out
// [P, Hkv, page, 2*D] (K in lanes [:D], V in lanes [D:]).
//
// What bounds it on the H100: bytes. Each K/V row is read once and used
// for 2*rep*D multiply-adds (rep = Hq/Hkv, 4 for Llama-3-8B), about two
// operations per byte, far below the ~295 the card needs to be bound by
// arithmetic. The design therefore reads every page once and nothing
// else:
//   - one block per (kv head, sequence, split of at most 256 rows): the
//     rep query heads of that kv head share each K/V row staged in shared
//     memory, which is GQA reuse with no broadcast copy in device memory;
//     splitting the sequence (flash-decoding) puts 8x more blocks in
//     flight than sequences x kv heads, and a second small kernel merges
//     the splits' partial (m, l, acc) by their log-sum-exp;
//   - page ids are read from the block table inside the kernel, and only
//     the ceil(len/page) pages a sequence uses are touched;
//   - a chunk of pages is staged in shared memory by 16-byte loads (a
//     page of one kv head is contiguous); rows at or past len are
//     zero-filled instead of loaded, so stale or NaN contents of a
//     recycled pool never enter a product;
//   - the online softmax keeps m, l and the accumulator in float32; a
//     split past the sequence's end does no work, and a sequence of
//     length 0 writes zeros.
// Not done yet (later work): cp.async/TMA prefetch of the next chunk
// behind the current one's math, and tensor-core products.
// The wrapper guarantees 2*D*sizeof(T) is a multiple of 16 bytes and a
// 16-byte aligned pool.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunkRows = 64;  // kv rows staged per iteration (whole pages)
constexpr int kSplitRows = 256;  // kv rows per block at most (whole chunks)

// floats of shared memory before the staged kv tile, rounded up to a
// 16-byte boundary
__host__ __device__ inline int float_words(int rep, int d, int ch) {
  return (2 * rep * d + rep * ch + 3 * rep + 3) / 4 * 4;
}

inline int chunk_pages_for(int page) { return max(1, kChunkRows / page); }

// pages per split: whole chunks, about kSplitRows rows
inline int split_pages_for(int page) {
  const int c = chunk_pages_for(page);
  return max(c, kSplitRows / page / c * c);
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

  // partial results of this split; an empty split leaves l = 0
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

// Merge the splits of each (sequence, q head): out = sum_s acc_s e^(m_s-M)
// / sum_s l_s e^(m_s-M), M = max_s m_s over splits that saw any row;
// zeros where none did (length 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          T* __restrict__ out, int d, int n_split) {
  const size_t row = blockIdx.x;  // b * Hq + q head
  const float* ml = part_ml + row * n_split * 2;
  float mx = NEG_INF_F;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float denom = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) denom += ml[2 * s + 1] * expf(ml[2 * s] - mx);
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s + 1] > 0.f)
        num += part_acc[(row * n_split + s) * d + e] * expf(ml[2 * s] - mx);
    out[row * d + e] = from_f32<T>(denom > 0.f ? num / denom : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* pool, const void* bt, const void* lens,
           void* part_acc, void* part_ml, void* out, int B, int hq, int hkv,
           int d, int page, int mp, int n_split, float scale,
           cudaStream_t stream) {
  const int rep = hq / hkv;
  const int chunk_pages = chunk_pages_for(page);
  const int ch = chunk_pages * page;
  const size_t smem = sizeof(float) * float_words(rep, d, ch) +
                      sizeof(T) * (size_t)ch * 2 * d;
  cudaFuncSetAttribute(paged_decode_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(hkv, B, n_split);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(bt), static_cast<const int*>(lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), hq, hkv,
      d, page, mp, chunk_pages, split_pages_for(page), scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<T><<<B * hq, min(kThreads, (d + 31) / 32 * 32),
                                 0, stream>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<T*>(out), d, n_split);
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

extern "C" int paged_decode(int dtype, const void* q, const void* pool,
                            const void* bt, const void* lens, void* part_acc,
                            void* part_ml, void* out, int B, int hq, int hkv,
                            int d, int page, int mp, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_split = paged_decode_splits(page, mp);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, pool, bt, lens, part_acc, part_ml, out,
                                 B, hq, hkv, d, page, mp, n_split, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, pool, bt, lens, part_acc, part_ml, out, B, hq,
                         hkv, d, page, mp, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
