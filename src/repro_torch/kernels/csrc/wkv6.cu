// wkv6: the RWKV6 time-mix recurrence with data-dependent decay, for
// Hopper.
//
// Replaces the TPU Pallas kernel `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan.py (launched by `wkv6`).
//
// What it computes.  Per (batch b, head h), with head dim n, inputs
// r, k, v, w [B, T, H, n], the bonus u [H, n] and the initial state
// s0 [B, H, n, n], for t = 0 .. T-1:
//     y[t, j] = sum_i r[t, i] * (u[i] * k[t, i] * v[t, j] + S[i, j])
//     S[i, j] = w[t, i] * S[i, j] + k[t, i] * v[t, j]
// giving y [B, T, H, n] and sT = S after step T-1 [B, H, n, n], both f32.
// r, k and v are read in their own type (f32 or bf16) and widened to f32
// in the kernel; w, u and s0 are f32.  All inputs are read through their
// strides in the JAX layout; the last dim must be contiguous.
//
// What bounds it on this card.  Per (token, head) it reads 4n input values
// and writes n, and does ~6 n^2 f32 operations: at n = 64 that is ~1.5
// operations per byte of HBM, so on paper the bytes and the f32 rate bound
// it about equally (B 2 x T 4096 x H 40: ~0.13 ms each).  In practice the
// bound is the recurrence itself: T steps run one after another, and only
// B * H * n^2 state cells exist to spread across the card.
//
// What the design does about it.  The TPU kernel's chunked closed form
// (cumulative decay products feeding the MXU) is not carried over: under
// strong decay it divides by a product that falls below the f32 range
// (rwkv6_scan.py:41-45), and Hopper blocks run in no order, so the
// sequential grid axis that carries S in VMEM has no counterpart.  Here
// each block owns one slice of CJ value columns j of one (b, h) and walks
// time in order; S[:, j] never leaves registers.  A column is split over
// RG threads of one warp, each holding 16 rows of it, so a step costs a
// thread 16 rows of work and the sum over i ends in RG-1 shuffles (no
// shared memory, no barrier inside a step).  The state update is written
// as the plain twin computes it (w * S, then + k v; this file is built
// with -fmad=false), so S agrees with the twin bit for bit and only the
// order of the sum over i differs.  Time is walked in tiles of `chunk`
// steps: the tile's r, k, w rows and the block's v columns are staged into
// shared memory with coalesced loads, then consumed.  Steps past T are
// never run, so padding cannot touch sT.  Tensor cores (sub-chunked closed
// forms with rescaling) and overlapping a tile's loads with the previous
// tile's steps are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;                 // rows of S[:, j] a thread holds
constexpr int kMaxSmem = 232448;          // a block's shared memory limit

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N> struct Shape {
  static constexpr int RG = N / kRows;                    // threads a column
  static constexpr int CJ = N < 64 / RG ? N : 64 / RG;    // columns a block
  static constexpr int kThreads = CJ * RG;
  static constexpr int kSlices = N / CJ;
};

template <int N>
constexpr size_t smem_bytes(int chunk) {
  return (size_t)chunk * (3 * N + Shape<N>::CJ) * sizeof(float);
}

// grid (N / CJ column slices, H, B); block CJ * RG threads.
template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int Tlen, int H,
            int chunk, long long rsb, long long rst, long long rsh,
            long long ksb, long long kst, long long ksh, long long vsb,
            long long vst, long long vsh, long long wsb, long long wst,
            long long wsh, long long ush, long long ssb, long long ssh,
            long long ssi) {
  constexpr int RG = Shape<N>::RG, CJ = Shape<N>::CJ;
  constexpr int NT = Shape<N>::kThreads;
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);   // [chunk][N]
  float* sk = sr + chunk * N;                    // [chunk][N]
  float* sw = sk + chunk * N;                    // [chunk][N]
  float* sv = sw + chunk * N;                    // [chunk][CJ]

  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int jl = tid / RG, g = tid % RG;
  const int j = slice * CJ + jl;
  const int i0 = g * kRows;

  const T* rb = r + b * rsb + h * rsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh + slice * CJ;
  const float* wb = w + b * wsb + h * wsh;

  float S[kRows], ur[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    S[ii] = s0[b * ssb + h * ssh + (i0 + ii) * ssi + j];
    ur[ii] = u[h * ush + i0 + ii];
  }

  for (int t0 = 0; t0 < Tlen; t0 += chunk) {
    const int len = min(chunk, Tlen - t0);
    __syncthreads();                      // the previous tile is consumed
#pragma unroll 4
    for (int idx = tid; idx < len * N; idx += NT) {
      const int t = idx / N, i = idx % N;
      const long long tt = t0 + t;
      sr[idx] = to_f(rb[tt * rst + i]);
      sk[idx] = to_f(kb[tt * kst + i]);
      sw[idx] = wb[tt * wst + i];
    }
#pragma unroll 4
    for (int idx = tid; idx < len * CJ; idx += NT) {
      const int t = idx / CJ, c = idx % CJ;
      sv[idx] = to_f(vb[(long long)(t0 + t) * vst + c]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float vt = sv[t * CJ + jl];
      const float4* r4 = reinterpret_cast<const float4*>(sr + t * N + i0);
      const float4* k4 = reinterpret_cast<const float4*>(sk + t * N + i0);
      const float4* w4 = reinterpret_cast<const float4*>(sw + t * N + i0);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = q * 4 + e;
          const float kv = kk[e] * vt;
          acc = fmaf(rr[e], ur[ii] * kv + S[ii], acc);
          S[ii] = ww[e] * S[ii] + kv;
        }
      }
#pragma unroll
      for (int off = RG / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) y[(((long long)b * Tlen + t0 + t) * H + h) * N + j] = acc;
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    sT[(((long long)b * H + h) * N + i0 + ii) * N + j] = S[ii];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int Tlen, int H, int chunk, const long long* st,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<N>(chunk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Shape<N>::kSlices, H, B);
  wkv6_kernel<T, N><<<grid, Shape<N>::kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, y, sT, Tlen, H, chunk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], st[15]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* r, const void* k, const void* v,
             const float* w, const float* u, const float* s0, float* y,
             float* sT, int B, int Tlen, int H, int chunk,
             const long long* st, cudaStream_t s) {
  if (n == 16)
    return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st, s);
  if (n == 32)
    return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st, s);
  if (n == 64)
    return launch<T, 64>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of r, k, v: 0 = f32, 1 = bf16; w, u, s0 are f32.  y [B, T, H, n]
// and sT [B, H, n, n] are contiguous f32.  strides in elements: r, k, v, w
// (b, t, h); u (h); s0 (b, h, i).  Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a head
// dim, type or tile it does not take.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* sT, int dtype,
                int B, int Tlen, int H, int n, int chunk, long long rsb,
                long long rst, long long rsh, long long ksb, long long kst,
                long long ksh, long long vsb, long long vst, long long vsh,
                long long wsb, long long wst, long long wsh, long long ush,
                long long ssb, long long ssh, long long ssi, void* stream) {
  const long long st[16] = {rsb, rst, rsh, ksb, kst, ksh, vsb, vst,
                            vsh, wsb, wst, wsh, ush, ssb, ssh, ssi};
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk <= 0 || Tlen < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const float *wf = (const float*)w, *uf = (const float*)u,
              *sf = (const float*)s0;
  if (dtype == 0)
    return dispatch<float>(n, r, k, v, wf, uf, sf, (float*)y, (float*)sT, B,
                           Tlen, H, chunk, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(n, r, k, v, wf, uf, sf, (float*)y,
                                   (float*)sT, B, Tlen, H, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
