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
//   - bf16 (the serving path) runs on the tensor cores: mma.sync
//     m16n8k16 with float32 accumulators, 4 warps x 16 q rows per 64-row
//     tile, P handed from the score accumulators to the PV product in
//     registers;
//   - float32 (the exact reference path of the tests) keeps scalar FMAs
//     on float32 tiles: one block per (64-row q tile, q head, batch row)
//     of 256 threads, each owning a 4x4 patch of the score tile.
// Both loop over 64-row kv tiles staged in shared memory, and the causal
// bound ends the loop early. Not done yet: wgmma and TMA with a
// warp-specialised pipeline (Hopper's full rate), cp.async double
// buffering of the next kv tile, and reading ctx pages through the block
// table instead of a gathered copy.
#include "common.cuh"

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
// bf16 variant on the tensor cores: mma.sync m16n8k16 with float32
// accumulators (FlashAttention-2's register layout). 4 warps, each owning
// 16 rows of the 64-row q tile; Q's fragments stay in registers for the
// whole kv loop; S = Q K^T and O += P V are tensor-core products, and P
// goes from S's accumulator registers straight into PV's A fragments.
// K is staged row-major and V transposed in shared memory, both with a
// 16-byte row pad (conflict-free fragment loads). Rows are loaded with
// 16-byte vectors: the wrapper guarantees 16-byte aligned rows.
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, int sq, int sk, int hq,
                     int hkv, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int QS = D + 8;     // row stride of the Q and K tiles
  constexpr int VS = kBK + 8;   // row stride of the transposed V tile
  constexpr int KK = D / 16;    // k16 steps over the head dim
  constexpr int NT = kBK / 8;   // n8 tiles of a 64-wide score row block
  constexpr int DT = D / 8;     // n8 tiles of the output
  constexpr int V8 = D / 8;     // 16-byte vectors per row

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  const int q0 = qt * kBQ, r0 = warp * 16;
  const int offset = sk - sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][QS]
  bf16* k_s = q_s + kBQ * QS;                     // [kBK][QS]
  bf16* vt_s = k_s + kBK * QS;                    // [D][VS]

  const bf16* q_base = q + b * q_sb + h * q_sh;
  const bf16* k_base = k + b * k_sb + hk * k_sh;
  const bf16* v_base = v + b * v_sb + hk * v_sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBQ * V8; i += kMmaThreads) {
    const int r = i / V8, c = i - r * V8;
    const int qpos = q0 + r;
    *reinterpret_cast<uint4*>(q_s + r * QS + c * 8) =
        qpos < sq ? *reinterpret_cast<const uint4*>(q_base + qpos * q_ss +
                                                    c * 8)
                  : zero;
  }
  __syncthreads();
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const bf16* p = q_s + (r0 + g) * QS + kk * 16 + tq * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * QS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * QS + 8);
  }

  // this thread's two rows: q0 + r0 + g and q0 + r0 + g + 8
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  int qpos[2], qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qpos[rr] = q0 + r0 + g + 8 * rr;
    qs[rr] = qseg != nullptr ? qseg[(size_t)b * sq + min(qpos[rr], sq - 1)]
                             : 0;
  }

  int n_kb = (sk + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (q0 + kBQ + offset + kBK - 1) / kBK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous iteration is done with k_s and vt_s
    for (int i = tid; i < kBK * V8; i += kMmaThreads) {
      const int r = i / V8, c = i - r * V8;
      const int kpos = k0 + r;
      *reinterpret_cast<uint4*>(k_s + r * QS + c * 8) =
          kpos < sk ? *reinterpret_cast<const uint4*>(k_base + kpos * k_ss +
                                                      c * 8)
                    : zero;
    }
    // V transposed; consecutive threads take consecutive rows, so their
    // 2-byte stores fall in consecutive shared-memory words
    for (int i = tid; i < kBK * V8; i += kMmaThreads) {
      const int r = i % kBK, c = i / kBK;
      const int kpos = k0 + r;
      uint4 val = kpos < sk ? *reinterpret_cast<const uint4*>(
                                  v_base + kpos * v_ss + c * 8)
                            : zero;
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c * 8 + j) * VS + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 kv columns
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const bf16* p = k_s + (nt * 8 + g) * QS + kk * 16 + tq * 2;
        mma_bf16(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // masks and online softmax; a row's values sit in the 4 lanes of
    // one quad (tq = 0..3), two columns per n8 tile each
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = NEG_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + nt * 8 + tq * 2 + e;
          bool keep = kpos < sk;
          if (causal) keep = keep && kpos <= qpos[rr] + offset;
          if (kseg != nullptr && keep)
            keep = kseg[(size_t)b * sk + kpos] == qs[rr];
          float& x = s[nt][rr * 2 + e];
          x = keep ? x * scale : NEG_INF_F;
          mx = fmaxf(mx, x);
        }
      mx = group_max<4>(mx);
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][rr * 2 + e];
          // a masked entry holds exactly NEG_INF_F; a live score is finite
          x = x == NEG_INF_F ? 0.f : expf(x - m_new);
          sum += x;
        }
      sum = group_sum<4>(sum);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        acc[t][rr * 2] *= alpha;
        acc[t][rr * 2 + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator layout is PV's A-fragment layout
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      const uint32_t a[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                             pack_bf16(s[2 * t][2], s[2 * t][3]),
                             pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                             pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* p = vt_s + (dt * 8 + g) * VS + t * 16 + tq * 2;
        mma_bf16(acc[dt], a, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qpos[rr] >= sq) continue;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
    bf16* o_row = o + b * o_sb + qpos[rr] * o_ss + h * o_sh;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(o_row + dt * 8 + tq * 2) =
          pack_bf16(acc[dt][rr * 2] / l_safe, acc[dt][rr * 2 + 1] / l_safe);
    if (tq == 0)
      lse[((size_t)b * sq + qpos[rr]) * hq + h] = m[rr] + logf(l_safe);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* qseg, const void* kseg, int B, int sq,
               int sk, int hq, int hkv, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBQ + kBK) * (D + 8) + (size_t)D * (kBK + 8));
  cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((sq + kBQ - 1) / kBQ, hq, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), sq, sk, hq, hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
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
// Head dims: those of the configs in CONFIGS (the wrapper refuses others).
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, void* lse, const void* qseg,
                         const void* kseg, int B, int sq, int sk, int hq,
                         int hkv, int d, const long long* strides, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    switch (d) {
      case 16: return launch_mma<16>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      case 64: return launch_mma<64>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      case 128: return launch_mma<128>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == DTYPE_F32) {
    switch (d) {
      case 16: return launch<float, 16>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      case 64: return launch<float, 64>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      case 128: return launch<float, 128>(q, k, v, o, lse, qseg, kseg, B, sq, sk, hq, hkv, strides, causal, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
