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
// reads kv-head h / G (GQA).  The cache is cut into splits of bk keys; each
// split is reduced with a local softmax to f32 partials (o, m, l) with o
// unnormalised, and the splits are merged with the online-softmax combine.
// f32 or bf16 in, f32 arithmetic, the input's type out.
//
// What bounds it on this card.  Bytes: every visible key and value is read
// once, 2 * B * kv_len * Hkv * hd * bytes, against 4 * hd operations per
// (q-head, key): a few operations per byte, so HBM at 3.35 TB/s is the
// bound.  At the serving shape (B 4, kv_len ~1088, Hkv 8, hd 128, f32)
// that is ~36 MB, ~11 us: the launch and the host's path to it are of the
// same size, so both are kept to one launch and a short wrapper.
//
// What the design does about it.
// - One block per (split, kv-head, batch) serves all G q-heads of its
//   kv-head, so each K/V row is read once and not G times (the Pallas grid
//   is (B, Hq, splits)).  G runs to 16 (qwen3_moe: 64 q-heads over 4
//   kv-heads): the block is built twice, holding 8 or 16 heads' P V sums
//   in registers, and a call takes the smallest build that covers its G,
//   so G <= 8 runs the 8-head build as before.  The scores' rows are
//   padded to 4, 8 or 16 heads; at 16 the wrapper halves the largest split
//   and split count so the scores and the merge still fit shared memory.
//   The wrapper sizes the splits to the card (about two blocks per SM, and
//   larger where a long cache would need more splits than the merge
//   stages), and only the ceil(kv_len / bk) splits that hold a visible key
//   are launched: a split wholly past kv_len is never read,
//   and inside the last split only the keys below kv_len are loaded, so
//   the cache tail cannot reach the result.
// - K and V stream through a 3-stage ring of shared-memory tiles of 16 KB
//   each (TK keys), filled by 16-byte `cp.async`: two tiles are in flight
//   while a third is consumed.  The split's K tiles come first, then its V
//   tiles, through the same ring.  Rows are padded by 64 bytes so that the
//   reads below are free of bank conflicts.
// - Scores: 4 lanes share one key, each summing a quarter of the head dim
//   for all G q-heads (q is read from shared memory as a broadcast), and 2
//   shuffles finish each dot.  All scores of the split are kept in shared
//   memory, so the softmax takes the split's exact maximum (as the plain
//   twin does) and nothing is rescaled: P V then accumulates p * v, each
//   warp over its own keys with a lane on each 16-byte chunk of the row,
//   and the warps' sums are added in a fixed order.
// - The merge runs in the same launch.  Each block writes its partials,
//   fences, and bumps a per-(batch, kv-head) counter; the block that
//   finishes last merges the kv-head's G q-heads over all splits, in split
//   order (so the result does not depend on which block was last), writes
//   the output and resets the counter to 0.  It stages every split's m and
//   l in shared memory first, then sums each of a thread's outputs over the
//   splits in split order, all of its outputs a split at a time, so their
//   loads of o are in flight together (at G 16 a thread merges 16
//   outputs).  The counters live in the wrapper's per-stream workspace,
//   zeroed once when it is made.
// - Optionally (a non-null `lse`) the merging block also writes each
//   q-head's log-sum-exp over the keys this launch saw, max + log(sum), in
//   f32: a sequence-parallel decode merges the ranks' outputs over their
//   key shards with it.  The output path is the same with or without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;         // q-heads per kv-head that a block serves
constexpr int kStages = 3;        // ring depth
constexpr int kTileBytes = 16384; // payload of one staged K or V tile
constexpr int kPadChunks = 4;     // 16-byte chunks of padding per staged row
constexpr int kMaxSmem = 232448;  // a block's shared memory limit

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

// The VEC elements of one 16-byte chunk, widened to f32.
__device__ __forceinline__ void widen(const float4& c, float (&x)[4]) {
  x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
}
__device__ __forceinline__ void widen(const float4& c, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// MG: the q-heads a block's registers hold, 8 or 16.  A call takes the
// smallest that covers its G, so G <= 8 runs the 8-head build unchanged.
template <typename T, int HD, int MG> struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int NC = HD / VEC;               // chunks a row
  static constexpr int RS = NC + kPadChunks;        // staged row, chunks
  static constexpr int TK = kTileBytes / (HD * (int)sizeof(T));  // keys
  static constexpr int CPL = NC / 4;                // chunks a score lane
  static constexpr int KPW = 32 / NC;               // keys a P V warp step
  static constexpr int kSets = kWarps * KPW;        // P V partial sums
  static constexpr int kStageBytes = TK * RS * 16;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static_assert(TK % 32 == 0 && NC % 4 == 0 && NC <= 32, "tile shape");
  // the warps' P V sums alias the ring and the q tile after it
  static_assert((kSets - 1) * MG * HD * 4 <= kRingBytes, "P V sums alias");
};

// Shared memory past the ring: q [G][HD] f32, scores [bk][GP] f32, m and l
// [kMaxG] f32, the "last block" flag.
__host__ __device__ inline int gpad(int G) {
  return G <= 4 ? 4 : G <= 8 ? 8 : 16;
}

template <typename T, int HD, int MG>
size_t smem_bytes(int G, int bk) {
  return (size_t)Geo<T, HD, MG>::kRingBytes + (size_t)G * HD * 4 +
         (size_t)bk * gpad(G) * 4 + 2 * kMaxG * 4 + 16;
}

template <typename T, int HD, int MG>
__global__ void __launch_bounds__(kThreads)
fd_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ o_part, float* __restrict__ m_part,
          float* __restrict__ l_part, int* __restrict__ counters,
          float* __restrict__ lse, int Hq,
          int G, int kv_len, int bk, int ns, long long qsb, long long qsh,
          long long ksb, long long kst, long long ksh, long long vsb,
          long long vst, long long vsh, float scale) {
  using Gm = Geo<T, HD, MG>;
  constexpr int VEC = Gm::VEC, NC = Gm::NC, RS = Gm::RS, TK = Gm::TK;
  constexpr int KPW = Gm::KPW;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* sQ = reinterpret_cast<float*>(ring + Gm::kRingBytes);  // [G][HD]
  float* sS = sQ + G * HD;                       // [bk][GP]: scores, then p
  float* sM = sS + bk * gpad(G);
  float* sL = sM + kMaxG;
  int* sFlag = reinterpret_cast<int*>(sL + kMaxG);
  const int GP = gpad(G);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = split * bk;
  const int nkeys = min(s0 + bk, kv_len) - s0;   // >= 1: split < ns
  const int nt = (nkeys + TK - 1) / TK;          // tiles of K, then of V
  const char* kb = reinterpret_cast<const char*>(
      k + b * ksb + hk * ksh + (long long)s0 * kst);
  const char* vb = reinterpret_cast<const char*>(
      v + b * vsb + hk * vsh + (long long)s0 * vst);
  const long long kstb = kst * (long long)sizeof(T);
  const long long vstb = vst * (long long)sizeof(T);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);

  auto load = [&](int it) {               // tile it: K tiles, then V tiles
    const bool isv = it >= nt;
    const int kt = isv ? it - nt : it;
    const char* src = isv ? vb : kb;
    const long long st = isv ? vstb : kstb;
    const int rows = min(TK, nkeys - kt * TK);
    const uint32_t dst = ring_s + (it % kStages) * Gm::kStageBytes;
    for (int idx = tid; idx < rows * NC; idx += kThreads) {
      const int r = idx / NC, c = idx % NC;
      cp_async16(dst + (r * RS + c) * 16,
                 src + (long long)(kt * TK + r) * st + c * 16);
    }
  };

  const int total = 2 * nt;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < total) load(it);
    cp_commit();
  }
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    sQ[idx] = to_f(q[b * qsb + (hk * G + g) * qsh + d]);
  }

  // P V accumulators of this lane: keys of sub-slot `sub` in each tile,
  // elements [c * VEC, c * VEC + VEC) of the row
  const int sub = lane / NC, pc = lane % NC;
  float o[MG][VEC];
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[g][e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    cp_wait<kStages - 2>();                // tile it has landed (this thread)
    __syncthreads();                       // ... for all; tile it-1 consumed
    if (it + kStages - 1 < total) load(it + kStages - 1);
    cp_commit();
    const float4* tile = reinterpret_cast<const float4*>(
        ring + (it % kStages) * Gm::kStageBytes);
    if (it < nt) {
      // scores of tile it: 4 lanes a key, CPL chunks each, all G heads
      const int part = tid % 4, ks = tid / 4;
      const int rows = min(TK, nkeys - it * TK);
#pragma unroll
      for (int kk = 0; kk < TK / 32; ++kk) {
        const int j = kk * 32 + ks;
        float acc[MG];
#pragma unroll
        for (int g = 0; g < MG; ++g) acc[g] = 0.0f;
#pragma unroll
        for (int i = 0; i < Gm::CPL; ++i) {
          const int c = part + 4 * i;
          float kx[VEC];
          widen(tile[j * RS + c], kx);
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g >= G) break;
            const float4* q4 = reinterpret_cast<const float4*>(
                sQ + g * HD + c * VEC);
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 qq = q4[e4];
              acc[g] = fmaf(qq.x, kx[4 * e4], acc[g]);
              acc[g] = fmaf(qq.y, kx[4 * e4 + 1], acc[g]);
              acc[g] = fmaf(qq.z, kx[4 * e4 + 2], acc[g]);
              acc[g] = fmaf(qq.w, kx[4 * e4 + 3], acc[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= G) break;
          acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 1);
          acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 2);
          if (g % 4 == part && j < rows)
            sS[(it * TK + j) * GP + g] = acc[g] * scale;
        }
      }
      continue;
    }
    if (it == nt) {
      // the split's softmax: warp w takes heads w, w + 4
      for (int g = warp; g < G; g += kWarps) {
        float mx = -INFINITY;
        for (int j = lane; j < nkeys; j += 32) mx = fmaxf(mx, sS[j * GP + g]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.0f;
        for (int j = lane; j < nkeys; j += 32) {
          const float p = expf(sS[j * GP + g] - mx);
          sS[j * GP + g] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          sM[g] = mx;
          sL[g] = sum;
        }
      }
      __syncthreads();
    }
    // P V of V tile it - nt: warp w, sub-slot sub take keys w * KPW + sub,
    // then every kWarps * KPW-th key
    const int vt = it - nt;
    const int rows = min(TK, nkeys - vt * TK);
    for (int j = warp * KPW + sub; j < rows; j += kWarps * KPW) {
      float vx[VEC];
      widen(tile[j * RS + pc], vx);
      const float4* p4 = reinterpret_cast<const float4*>(
          sS + (vt * TK + j) * GP);
      float p[MG] = {};
#pragma unroll
      for (int c = 0; c < MG / 4; ++c) {
        if (4 * c >= GP) break;
        const float4 pc4 = p4[c];
        p[4 * c] = pc4.x; p[4 * c + 1] = pc4.y;
        p[4 * c + 2] = pc4.z; p[4 * c + 3] = pc4.w;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[g][e] = fmaf(p[g], vx[e], o[g][e]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                        // the ring is free: alias the sums

  float* sO = reinterpret_cast<float*>(ring);    // [kSets][G][HD]
  const int set = warp * KPW + sub;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < VEC; ++e) sO[(set * G + g) * HD + pc * VEC + e] = o[g][e];
  }
  __syncthreads();
  const long long row0 = ((long long)b * Hq + hk * G) * ns + split;
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float acc = 0.0f;
    for (int s = 0; s < Gm::kSets; ++s) acc += sO[(s * G + g) * HD + d];
    o_part[(row0 + (long long)g * ns) * HD + d] = acc;
  }
  if (tid < G) {
    m_part[row0 + (long long)tid * ns] = sM[tid];
    l_part[row0 + (long long)tid * ns] = sL[tid];
  }

  // the merge, by the block of this (batch, kv-head) that finishes last
  __threadfence();
  __syncthreads();
  int* cnt = counters + b * (Hq / G) + hk;
  if (tid == 0) {
    const int prev = atomicAdd(cnt, 1);
    *sFlag = prev == ns - 1;
    if (prev == ns - 1) *cnt = 0;          // ready for the next launch
  }
  __syncthreads();
  if (!*sFlag) return;
  __threadfence();
  // m and l of all splits into shared memory (the ring is free), the
  // splits' weights exp(m - max m) and the denominator by one thread a
  // head, then each output sums its splits in split order
  const long long base = ((long long)b * Hq + hk * G) * ns;
  float* sW = reinterpret_cast<float*>(ring);    // [G][ns]: m, then weights
  float* sLs = sW + G * ns;                      // [G][ns]: l
  float* sDen = sLs + G * ns;                    // [G]
  for (int i = tid; i < G * ns; i += kThreads) {
    sW[i] = __ldcg(m_part + base + i);
    sLs[i] = __ldcg(l_part + base + i);
  }
  __syncthreads();
  if (tid < G) {
    float mg = -INFINITY;
    for (int s = 0; s < ns; ++s) mg = fmaxf(mg, sW[tid * ns + s]);
    float den = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(sW[tid * ns + s] - mg);
      sW[tid * ns + s] = w;
      den += w * sLs[tid * ns + s];
    }
    sDen[tid] = den;
    if (lse != nullptr)
      lse[(long long)b * Hq + hk * G + tid] = mg + logf(den);
  }
  __syncthreads();
  // each output sums its splits in split order; a thread's outputs (idx
  // = tid + j * kThreads) go a split at a time, so their loads of o are in
  // flight together (at 16 heads a thread merges up to 16 outputs)
  constexpr int kOut = MG * HD / kThreads;
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
  for (int s = 0; s < ns; ++s) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int idx = tid + j * kThreads, g = idx / HD, d = idx % HD;
      if (idx < G * HD)
        acc[j] += __ldcg(o_part + (base + (long long)g * ns + s) * HD + d) *
                  sW[g * ns + s];
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int idx = tid + j * kThreads, g = idx / HD, d = idx % HD;
    if (idx < G * HD)
      out[((long long)b * Hq + hk * G + g) * HD + d] =
          from_f<T>(acc[j] / fmaxf(sDen[g], 1e-30f));
  }
}

template <typename T, int HD, int MG>
int launch(const void* q, const void* k, const void* v, void* out,
           int* counters, float* part, float* lse, int B, int Hq, int Hkv,
           int kv_len, int bk, int ns, const long long* st, int device,
           cudaStream_t stream) {
  static uint64_t attr_set = 0;           // per device, once
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes<T, HD, MG>(G, bk);
  if (smem > (size_t)kMaxSmem || device < 0 || device >= 64 || G > MG ||
      (size_t)(2 * ns + 1) * G * 4 > (size_t)Geo<T, HD, MG>::kRingBytes)
    return (int)cudaErrorInvalidValue;
  if (!(attr_set >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fd_kernel<T, HD, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= 1ull << device;
  }
  const long long rows = (long long)B * Hq * ns;
  float* o_part = part;
  float* m_part = o_part + rows * HD;
  float* l_part = m_part + rows;
  fd_kernel<T, HD, MG><<<dim3(ns, Hkv, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, o_part, m_part, l_part,
      counters, lse, Hq, G, kv_len, bk, ns, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One call, its arguments packed into 25 int64 (one ctypes argument keeps
// the wrapper's host path short):
//   a[0..4]   q, k, v, out, work (addresses)
//   a[5..13]  ncnt, dtype (0 f32, 1 bf16), B, Hq, Hkv, hd, kv_len, bk, ns
//   a[14..21] strides in elements: q (b, h), k (b, t, h), v (b, t, h)
//   a[22..23] device, stream
//   a[24]     lse (address of f32 [B, Hq], or 0: not written)
// ns = ceil(kv_len / bk) splits are launched, one block per (split,
// kv-head, batch).  `work` is the workspace: `ncnt` int32 counters, zero
// between launches (the first B * Hkv are used), then f32 partials o [B,
// Hq, ns, hd], m and l [B, Hq, ns].  k and v rows must be 16-byte
// aligned; `out` is contiguous [B, Hq * hd].  Launches on the stream of
// `device` (made current for the launch if it is not); returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a head
// dim, type, group or plan it does not take.
int flash_decode_launch(const long long* a) {
  const void *q = (const void*)a[0], *k = (const void*)a[1],
             *v = (const void*)a[2];
  void *out = (void*)a[3], *work = (void*)a[4];
  const int ncnt = (int)a[5], dtype = (int)a[6], B = (int)a[7],
            Hq = (int)a[8], Hkv = (int)a[9], hd = (int)a[10],
            kv_len = (int)a[11], bk = (int)a[12], ns = (int)a[13];
  const long long* st = a + 14;
  const int device = (int)a[22];
  float* lse = (float*)a[24];
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || kv_len <= 0 ||
      bk <= 0 || ns != (kv_len + bk - 1) / bk || ncnt < B * Hkv ||
      ncnt % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)a[23];
  int* cnt = (int*)work;
  float* part = (float*)(cnt + ncnt);
  const bool wide = Hq / Hkv > 8;        // the 16-head build
  int rc = (int)cudaErrorInvalidValue;
#define FD_LAUNCH(T, HD)                                                     \
  rc = wide ? launch<T, HD, 16>(q, k, v, out, cnt, part, lse, B, Hq, Hkv,   \
                                kv_len, bk, ns, st, device, s)               \
            : launch<T, HD, 8>(q, k, v, out, cnt, part, lse, B, Hq, Hkv,    \
                               kv_len, bk, ns, st, device, s)
  if (dtype == 0 && hd == 64)
    FD_LAUNCH(float, 64);
  else if (dtype == 0 && hd == 128)
    FD_LAUNCH(float, 128);
  else if (dtype == 1 && hd == 64)
    FD_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == 1 && hd == 128)
    FD_LAUNCH(__nv_bfloat16, 128);
#undef FD_LAUNCH
  if (cur != device) cudaSetDevice(cur);
  return rc;
}

}  // extern "C"
