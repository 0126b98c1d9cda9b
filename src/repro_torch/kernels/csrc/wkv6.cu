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
// strides in the JAX layout; the last dim must be contiguous and each row
// 16-byte aligned.  T may be 1 (a decode step) or 0 (sT = s0).
//
// What bounds it on this card.  Per (token, head) it reads 4n input values
// and writes n, and does ~6 n^2 f32 operations: at n = 64 that is ~1.5
// operations per byte of HBM, so on paper the bytes and the f32 rate bound
// it about equally (B 2 x T 4096 x H 40: ~0.13 ms each).  In practice the
// bound is the recurrence itself: T steps run one after another, and only
// B * H * n^2 state cells exist to spread across the card.  At T = 1 the
// state is the whole cost: it is read once and written once.
//
// What the design does about it.  The TPU kernel's chunked closed form
// (cumulative decay products feeding the MXU) is not carried over: under
// strong decay it divides by a product that falls below the f32 range
// (rwkv6_scan.py:41-45).  Each thread owns kRows = 8 rows of one value
// column j of S in registers and walks time in order; RG = n / 8 threads
// of one warp share a column (8 rows measured faster than 16, whose
// half as many warps hide each step's latency worse, and than 4, whose
// extra loads and shuffles cost more than the warps gain).
// - Staging overlapped with compute.  Time is walked in tiles of `chunk`
//   steps through a double buffer in shared memory: tile i+1's rows of r,
//   k, v (in their own type, so bf16 stages half the bytes) and w are in
//   flight while tile i is consumed.  Each row is one 1-D bulk copy (TMA)
//   completing on the stage's mbarrier; since a bulk copy takes
//   warp-uniform operands (a warp issues its lanes' copies one by one),
//   the copies are dealt across all warps.
// - Each tile is read once per head.  At n = 64 a cluster of four
//   16-column blocks shares each tile: each block issues a quarter of the
//   tile's row copies, multicast into all four blocks' shared memory, and
//   a cluster barrier frees a buffer before it is refilled (per-buffer
//   "empty" mbarriers with remote arrives measured slower).  One block of
//   n * RG threads a (head, batch) covering all 64 columns measured
//   slower at every rwkv6_3b shape: it leaves SMs idle (80 blocks for 132
//   SMs at scoring) or runs a second wave, where four a head spread
//   evenly.  At n = 16 and 32 a column slice of 16 would leave a block
//   too few threads, so one block covers the head.  The wrapper picks the
//   longest tile that keeps the whole grid resident
//   (rwkv6_scan.auto_chunk): every tile boundary costs a barrier.
// - A short chain for y.  A thread's 8 terms of y's sum over i go into 4
//   independent partial sums (term ii into sum ii % 4, in order), added as
//   (s0 + s1) + (s2 + s3); the RG threads of the column then add theirs by
//   a shuffle butterfly (staging the partials in shared memory and adding
//   them every 8 steps instead measured slower).  The state update is
//   written as the plain twin computes it (w * S, then + k v; this file is
//   built with -fmad=false), so S agrees with the twin bit for bit and
//   only the order of y's sum differs.
// - Bank-conflict-free reads: thread g of a column owns the rows of the
//   16-byte chunks g, g + RG, g + 2 RG, ..., so the RG threads read
//   neighbouring chunks of a row.  State loads and stores put neighbouring
//   threads on neighbouring j, so each warp access fills whole 32-byte
//   sectors.  Steps past T are never run, so padding cannot touch sT.
// Tensor cores (a sub-chunked closed form with rescaling) are left for a
// later change: their bf16 or TF32 operands cannot hold the 5e-5 gate
// against the f32 recurrence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;          // a block's shared memory limit
constexpr int kBarBytes = 16;             // two mbarriers
constexpr int kRows = 8;                  // rows of S[:, j] a thread holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The elements of one 16-byte chunk, widened to f32.
__device__ __forceinline__ void widen(const float* p, float (&x)[4]) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&x)[8]) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// Returns once the phase of parity `parity` has completed; traps (a launch
// error, not a hang) if it has not within ~2 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  } while (!done);
}
// One 1-D bulk copy global -> shared, completing on `bar`; with CS > 1,
// multicast to the same offset in every block of the cluster.
template <int CS>
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  if constexpr (CS == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  } else {
    const uint16_t mask = (1u << CS) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
  }
}
template <int CS> __device__ __forceinline__ void block_sync() {
  if constexpr (CS == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}
// Between tiles: every thread of the cluster is done reading a buffer (each
// value it loaded has fed its step's arithmetic, which precedes this in
// program order), so the arrive need not order memory; relaxed measured
// faster than release.
template <int CS> __device__ __forceinline__ void tile_sync() {
  if constexpr (CS == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                 "barrier.cluster.wait.aligned;" ::: "memory");
  }
}

template <typename T, int N, int CS> struct Cfg {
  static constexpr int RG = N / kRows;             // threads a column
  static constexpr int CJ = N / CS;                // columns a block
  static constexpr int kThreads = CJ * RG;
  static constexpr int kWarps = (kThreads + 31) / 32;
  static constexpr int CW = 32 / RG;               // columns a warp
  static constexpr int VEC = 16 / (int)sizeof(T);  // r/k/v elements a chunk
  static constexpr int CPT = kRows / VEC;          // r/k chunks a thread
  static constexpr int kRow = N * (int)sizeof(T);  // bytes: r/k/v row
  static constexpr int kRowW = N * 4;              // bytes: w row
  static constexpr int kStep = 3 * kRow + kRowW;   // bytes: a staged step
  static_assert(CJ >= 8 && kThreads <= 1024, "grid shape");
};

template <typename T, int N, int CS>
constexpr size_t smem_bytes(int chunk) {
  return (size_t)2 * chunk * Cfg<T, N, CS>::kStep + kBarBytes;
}

// grid (CS, H, B), clusters of CS blocks along x; block CJ * RG threads.
template <typename T, int N, int CS>
__global__ void __launch_bounds__(Cfg<T, N, CS>::kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int Tlen, int H,
            int chunk, long long rsb, long long rst, long long rsh,
            long long ksb, long long kst, long long ksh, long long vsb,
            long long vst, long long vsh, long long wsb, long long wst,
            long long wsh, long long ush, long long ssb, long long ssh,
            long long ssi) {
  using C = Cfg<T, N, CS>;
  constexpr int RG = C::RG, CJ = C::CJ, CW = C::CW, VEC = C::VEC;
  constexpr int CPT = C::CPT, kRow = C::kRow, kRowW = C::kRowW;
  extern __shared__ float4 smem4[];
  char* buf = reinterpret_cast<char*>(smem4);
  const int stage_bytes = chunk * C::kStep;
  const uint32_t bar0 = smem_u32(buf + 2 * stage_bytes);

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int jl = warp * CW + lane % CW, g = lane / CW;
  const int j = rank * CJ + jl;

  // row bases of this (b, h) in bytes, and their steps along t
  const char* src[4] = {
      reinterpret_cast<const char*>(r + b * rsb + h * rsh),
      reinterpret_cast<const char*>(k + b * ksb + h * ksh),
      reinterpret_cast<const char*>(v + b * vsb + h * vsh),
      reinterpret_cast<const char*>(w + b * wsb + h * wsh)};
  const long long step[4] = {rst * (long long)sizeof(T),
                             kst * (long long)sizeof(T),
                             vst * (long long)sizeof(T), wst * 4LL};
  const int ntile = (Tlen + chunk - 1) / chunk;

  // tile i into stage s: 4 * len row copies, this block's share of them
  auto issue = [&](int i, int s) {
    const int t0 = i * chunk, len = min(chunk, Tlen - t0);
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t st = smem_u32(buf + s * stage_bytes);
    if (tid == 0) mbar_expect_tx(bar, (uint32_t)(len * C::kStep));
    // a bulk copy takes warp-uniform operands, so a warp issues its lanes'
    // copies one after another: deal the copies across the warps
    for (int q = rank + CS * (lane * C::kWarps + warp); q < 4 * len;
         q += C::kThreads * CS) {
      const int a = q / len, t = q % len;
      const uint32_t bytes = a == 3 ? kRowW : kRow;
      bulk_load<CS>(st + a * chunk * kRow + t * bytes,
                    src[a] + (long long)(t0 + t) * step[a], bytes, bar);
    }
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  block_sync<CS>();
  for (int i = 0; i < 2 && i < ntile; ++i) issue(i, i);

  // this thread's rows: chunks g + RG m (m < CPT), VEC rows each
  float S[kRows], ur[kRows];
#pragma unroll
  for (int m = 0; m < CPT; ++m)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int i = (g + RG * m) * VEC + e;
      S[m * VEC + e] = s0[b * ssb + h * ssh + i * ssi + j];
      ur[m * VEC + e] = u[h * ush + i];
    }

  for (int i = 0; i < ntile; ++i) {
    const int s = i & 1, t0 = i * chunk, len = min(chunk, Tlen - t0);
    mbar_wait(bar0 + 8 * s, (i >> 1) & 1);
    const char* st = buf + s * stage_bytes;
    const char* sr = st;
    const char* sk = st + chunk * kRow;
    const char* sv = st + 2 * chunk * kRow;
    const char* sw = st + 3 * chunk * kRow;
    for (int t = 0; t < len; ++t) {
      const float vt = to_f(reinterpret_cast<const T*>(sv + t * kRow)[j]);
      const T* rt = reinterpret_cast<const T*>(sr + t * kRow);
      const T* kt = reinterpret_cast<const T*>(sk + t * kRow);
      const float4* w4 = reinterpret_cast<const float4*>(sw + t * kRowW);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int c = g + RG * m;
        float rx[VEC], kx[VEC], wx[VEC];
        widen(rt + c * VEC, rx);
        widen(kt + c * VEC, kx);
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 wq = w4[c * (VEC / 4) + e4];
          wx[4 * e4] = wq.x; wx[4 * e4 + 1] = wq.y;
          wx[4 * e4 + 2] = wq.z; wx[4 * e4 + 3] = wq.w;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int ii = m * VEC + e;
          const float kv = kx[e] * vt;
          acc[ii & 3] = fmaf(rx[e], ur[ii] * kv + S[ii], acc[ii & 3]);
          S[ii] = wx[e] * S[ii] + kv;
        }
      }
      float part = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int off = CW; off < 32; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (g == 0) y[(((long long)b * Tlen + t0 + t) * H + h) * N + j] = part;
    }
    if (i + 2 < ntile) {
      tile_sync<CS>();                  // every block is done with stage s
      issue(i + 2, s);
    }
  }
  if constexpr (CS > 1) block_sync<CS>();    // no copy still targets a peer

#pragma unroll
  for (int m = 0; m < CPT; ++m)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int i = (g + RG * m) * VEC + e;
      sT[(((long long)b * H + h) * N + i) * N + j] = S[m * VEC + e];
    }
}

template <typename T, int N, int CS>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int Tlen, int H, int chunk, const long long* st, int device,
           cudaStream_t stream) {
  static uint64_t attr_set = 0;          // per device, once
  chunk = Tlen < chunk ? (Tlen > 0 ? Tlen : 1) : chunk;   // a short T
  const size_t smem = smem_bytes<T, N, CS>(chunk);
  if (smem > (size_t)kMaxSmem || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  if (!(attr_set >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, N, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= 1ull << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, H, B);
  cfg.blockDim = dim3(Cfg<T, N, CS>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wkv6_kernel<T, N, CS>, (const T*)r, (const T*)k, (const T*)v, w,
      u, s0, y, sT, Tlen, H, chunk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid shape follows n: a cluster of four blocks a head at n = 64,
// one block a head at n = 16 and 32.
template <typename T>
int dispatch(int n, const void* r, const void* k, const void* v,
             const float* w, const float* u, const float* s0, float* y,
             float* sT, int B, int Tlen, int H, int chunk,
             const long long* st, int dev, cudaStream_t s) {
  if (n == 16)
    return launch<T, 16, 1>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st,
                            dev, s);
  if (n == 32)
    return launch<T, 32, 1>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st,
                            dev, s);
  if (n == 64)
    return launch<T, 64, 4>(r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk, st,
                            dev, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One call, its arguments packed into 32 int64 (one ctypes argument keeps
// the wrapper's host path short):
//   a[0..7]   r, k, v, w, u, s0, y, sT (addresses)
//   a[8..13]  dtype of r, k, v (0 f32, 1 bf16), B, T, H, n, chunk
//   a[14..29] strides in elements: r, k, v, w (b, t, h); u (h); s0 (b, h, i)
//   a[30..31] device, stream
// w, u and s0 are f32; y [B, T, H, n] and sT [B, H, n, n] are contiguous
// f32.  Launches on the stream of `device` (made current for the launch if
// it is not); returns the launch's CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dim, type or tile it does not take.
int wkv6_launch(const long long* a) {
  const void *r = (const void*)a[0], *k = (const void*)a[1],
             *v = (const void*)a[2];
  const float *w = (const float*)a[3], *u = (const float*)a[4],
              *s0 = (const float*)a[5];
  float *y = (float*)a[6], *sT = (float*)a[7];
  const int dtype = (int)a[8], B = (int)a[9], Tlen = (int)a[10],
            H = (int)a[11], n = (int)a[12], chunk = (int)a[13];
  const long long* st = a + 14;
  const int device = (int)a[30];
  if (chunk <= 0 || Tlen < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)a[31];
  const int rc =
      dtype == 0
          ? dispatch<float>(n, r, k, v, w, u, s0, y, sT, B, Tlen, H, chunk,
                            st, device, s)
          : dispatch<__nv_bfloat16>(n, r, k, v, w, u, s0, y, sT, B, Tlen, H,
                                    chunk, st, device, s);
  if (cur != device) cudaSetDevice(cur);
  return rc;
}

}  // extern "C"
