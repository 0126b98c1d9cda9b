// flash_attention: blocked online-softmax attention for Hopper.
//
// Replaces the TPU Pallas kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention`).
//
// What it computes.  q [B, S, Hq, hd], k/v [B, T, Hkv, hd] -> out
// [B, S, Hq*hd]: query row i sees key j iff j <= i (causal), i - j < window
// (window > 0) and j < T; q-head h reads kv-head h / G with G = Hq / Hkv
// (GQA).  Inputs are f32 or bf16, read through their strides in the JAX
// layout (no transposes; the head dim must be contiguous); every product
// and sum is taken in f32, and the output has the input's type.  A query
// row that sees no key at all (only possible with a window and S > T) is
// left at zero, where the dense reference averages V; the LM never asks
// for one.
//
// What bounds it on this card.  Operations: 4 * hd f32 multiply-adds per
// visible (query, key) pair against 2 * hd * (S + T) bytes of input, far
// above the H100's ~20 f32 operations per byte of HBM.  Its bound is the
// pair count times 4 * hd over the peak of the input type (989 TFLOP/s for
// bf16 on the tensor cores, 67 TFLOP/s for f32 outside them).
//
// What the design does about it.  One block of 256 threads per (tile of
// 64 query rows, q-head, batch).  The scaled Q tile stays in shared memory
// for the whole sweep; each 64-key K/V tile of the kv-head is staged once
// into shared memory and used by all 64 rows.  Each thread owns 4 rows x 4
// keys of the score tile and 4 rows x hd/16 columns of the output, so the
// running max m, sum l and the accumulator stay in registers, and the row
// reductions are shuffles inside a half-warp.  KV tiles wholly outside the
// causal or window range are skipped, as `flash_attention.py:34-43` prunes
// them; a ragged S or T edge is masked in the last tile, so every output
// row is written whatever S is.  The products run on the CUDA cores in
// f32, so bf16 runs far below the tensor-core bound: moving the two
// products onto `wgmma` with a pipelined K/V ring is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per staged tile
constexpr int kThreads = 256;    // 16 x 16: rows in groups of 4, cols by 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
          int Hq, int G, long long qsb, long long qss, long long qsh,
          long long ksb, long long kst, long long ksh, long long vsb,
          long long vst, long long vsh, int causal, int window,
          float scale) {
  constexpr int QP = HD + 1;     // padded rows: conflict-free column reads
  constexpr int PP = kBK + 1;
  constexpr int DPT = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QP], pre-scaled
  float* Ks = Qs + kBQ * QP;     // [kBK][QP]
  float* Vs = Ks + kBK * QP;     // [kBK][HD]
  float* Ps = Vs + kBK * HD;     // [kBQ][PP]

  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    Qs[r * QP + d] = (q0 + r < S) ? to_f(qb[(q0 + r) * qss + d]) * scale
                                  : 0.0f;
  }

  // KV tiles [lo, hi) that can hold a visible key for rows q0..q0+kBQ-1
  const int nkv = (Tk + kBK - 1) / kBK;
  int hi = nkv;
  if (causal) hi = min(nkv, (q0 + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.0f;
  }

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();             // Q staged / previous tile fully read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Tk;
      Ks[r * QP + d] = in ? to_f(kb[(k0 + r) * kst + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f(vb[(k0 + r) * vst + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[i][c];
        if (kj >= Tk) {
          x = -INFINITY;         // padding: excluded outright
        } else if ((causal && kj > qi) || (window > 0 && qi - kj >= window)) {
          x = kNegInf;
        }
        s[i][c] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * c] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = Vs[c * HD + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dd] = fmaf(pv[i], vv, acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * S + r) * Hq + h) * HD;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      o[tx + 16 * dd] = from_f<T>(acc[i][dd] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int Hq, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  const size_t shmem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  fa_kernel<T, HD><<<grid, kThreads, shmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, Hq, Hq / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  strides: q (b, s, h), k (b, t, h), v (b, t, h)
// in elements.  Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a head dim or type it does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int S, int Tk,
                           int Hq, int Hkv, int hd, long long qsb,
                           long long qss, long long qsh, long long ksb,
                           long long kst, long long ksh, long long vsb,
                           long long vst, long long vsh, int causal,
                           int window, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return 0;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                             window, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                              window, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Tk, Hq, Hkv, st,
                                     causal, window, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, S, Tk, Hq, Hkv, st,
                                      causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
