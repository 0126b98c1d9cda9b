// flash_decode: split-K attention of one query token over a KV cache, for
// Hopper.
//
// Replaces the TPU Pallas kernel `_fd_kernel` in
// src/repro/kernels/flash_decode.py (launched by `flash_decode`), and the
// merge of its split partials that the reference runs as jnp ops after the
// kernel (flash_decode.py:97-105).
//
// What it computes.  q [B, 1, Hq, hd] over a cache k/v [B, T, Hkv, hd], of
// which the first kv_len keys are visible: out [B, 1, Hq*hd].  q-head h
// reads kv-head h / G (GQA).  The cache is cut into splits of bk keys;
// phase 1 reduces each split with a local softmax to f32 partials (o, m, l)
// with o unnormalised, and phase 2 merges the splits with the online-softmax
// combine.  f32 or bf16 in, f32 arithmetic, the input's type out.
//
// What bounds it on this card.  Bytes: every visible key and value is read
// once, 2 * B * kv_len * Hkv * hd * bytes, against 4 * hd operations per
// (q-head, key): a few operations per byte, so HBM at 3.35 TB/s is the
// bound.
//
// What the design does about it.  Phase 1 runs one block per (split,
// kv-head, batch) that serves all G q-heads of its kv-head, so each K/V
// split is read once and not G times (the Pallas grid is (B, Hq, splits)).
// Only the splits that hold a visible key are launched: kv_len is a host
// int, so a split wholly past kv_len is never read and adds exactly zero to
// the merge, whatever the cache tail holds.  Inside the last split, keys
// at or past kv_len are excluded (-inf, weight 0).  Each of the 8 warps
// walks every 8th key of the split, 4 keys per step so that 8 loads are in
// flight; a lane holds hd/32 elements of q, of the accumulators and of
// each key, and a score is a warp-shuffle sum.  The warps' partials are
// combined in shared memory.  Phase 2 is one block per (q-head, batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;         // q-heads per kv-head that a block serves
constexpr int kUnroll = 4;       // keys per warp step

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, float* __restrict__ o_part,
                float* __restrict__ m_part, float* __restrict__ l_part,
                int Hq, int G, int kv_len, int bk, int ns, long long qsb,
                long long qsh, long long ksb, long long kst, long long ksh,
                long long vsb, long long vst, long long vsh, float scale) {
  constexpr int EPL = HD / 32;   // elements per lane
  __shared__ float wo[kWarps][kMaxG][HD];
  __shared__ float wm[kWarps][kMaxG];
  __shared__ float wl[kWarps][kMaxG];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = split * bk;
  const int s1 = min(s0 + bk, kv_len);
  const T* kb = k + b * ksb + hk * ksh + lane * EPL;
  const T* vb = v + b * vsb + hk * vsh + lane * EPL;

  float qr[kMaxG][EPL], o[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      o[g][e] = 0.0f;
      qr[g][e] = g < G ? to_f(q[b * qsb + (hk * G + g) * qsh + lane * EPL + e])
                       : 0.0f;
    }
  }

  for (int base = s0 + warp; base < s1; base += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kWarps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = j < s1 ? to_f(kb[j * kst + e]) : 0.0f;
        vr[u][e] = j < s1 ? to_f(vb[j * vst + e]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float smax = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[u][e], part);
        const float dot = warp_sum(part) * scale;
        s[u] = base + u * kWarps < s1 ? dot : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      // base < s1, so s[0] is finite and so is smax
      const float alpha = expf(m[g] - smax);
      float psum = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - smax);
        psum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[g][e] = fmaf(p, vr[u][e], o[g][e]);
      }
      l[g] = l[g] * alpha + psum;
      m[g] = smax;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < EPL; ++e) wo[warp][g][lane * EPL + e] = o[g][e];
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  __syncthreads();

  // combine the warps: a warp that saw no key has m = -inf and weight 0
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float acc = 0.0f, den = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = wm[w][g] == -INFINITY ? 0.0f : expf(wm[w][g] - mx);
      acc += wo[w][g][d] * a;
      den += wl[w][g] * a;
    }
    const long long row = ((long long)b * Hq + hk * G + g) * ns + split;
    o_part[row * HD + d] = acc;
    if (d == 0) {
      m_part[row] = mx;
      l_part[row] = den;
    }
  }
}

template <typename T, int HD>
__global__ void fd_merge_kernel(const float* __restrict__ o_part,
                                const float* __restrict__ m_part,
                                const float* __restrict__ l_part,
                                T* __restrict__ out, int Hq, int ns) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long row0 = ((long long)b * Hq + h) * ns;
  float mg = -INFINITY;
  for (int s = 0; s < ns; ++s) mg = fmaxf(mg, m_part[row0 + s]);
  float acc = 0.0f, den = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(m_part[row0 + s] - mg);
    den += w * l_part[row0 + s];
    acc += o_part[(row0 + s) * HD + d] * w;
  }
  out[((long long)b * Hq + h) * HD + d] = from_f<T>(acc / fmaxf(den, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* o_part, float* m_part, float* l_part, int B, int Hq,
           int Hkv, int kv_len, int bk, int ns, const long long* st,
           cudaStream_t stream) {
  fd_split_kernel<T, HD><<<dim3(ns, Hkv, B), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, o_part, m_part, l_part, Hq,
      Hq / Hkv, kv_len, bk, ns, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], 1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fd_merge_kernel<T, HD><<<dim3(Hq, B), HD, 0, stream>>>(
      o_part, m_part, l_part, (T*)out, Hq, ns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  ns = ceil(kv_len / bk) splits are launched;
// o_part [B, Hq, ns, hd], m_part and l_part [B, Hq, ns] are f32 scratch.
// strides: q (b, h), k (b, t, h), v (b, t, h) in elements.  Launches both
// phases on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim, type or group it does not take.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        void* out, void* o_part, void* m_part, void* l_part,
                        int dtype, int B, int Hq, int Hkv, int hd, int kv_len,
                        int bk, int ns, long long qsb, long long qsh,
                        long long ksb, long long kst, long long ksh,
                        long long vsb, long long vst, long long vsh,
                        void* stream) {
  const long long st[8] = {qsb, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  float *op = (float*)o_part, *mp = (float*)m_part, *lp = (float*)l_part;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || kv_len <= 0 ||
      bk <= 0 || ns != (kv_len + bk - 1) / bk)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, op, mp, lp, B, Hq, Hkv, kv_len,
                             bk, ns, st, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, op, mp, lp, B, Hq, Hkv, kv_len,
                              bk, ns, st, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, op, mp, lp, B, Hq, Hkv,
                                     kv_len, bk, ns, st, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, op, mp, lp, B, Hq, Hkv,
                                      kv_len, bk, ns, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
