// flash_attention: blocked online-softmax attention for Hopper.
//
// Replaces the TPU Pallas kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention`).
//
// What it computes.  q [B, S, Hq, hd], k/v [B, T, Hkv, hd] -> out
// [B, S, Hq*hd]: query row i sees key j iff j <= i (causal), i - j < window
// (window > 0) and j < T; q-head h reads kv-head h / G with G = Hq / Hkv
// (GQA).  Inputs are read through their strides in the JAX layout (no
// transposes; the head dim must be contiguous); the output has the input's
// type.  A query row that sees no key at all (only possible with a window
// and S > T) is left at zero, where the dense reference averages V; the LM
// never asks for one.
//
// What bounds it on this card.  Operations: 4 * hd multiply-adds per
// visible (query, key) pair against 2 * hd * (S + T) elements of input, far
// above the ~295 bf16 tensor-core operations the H100 does per byte of HBM.
// Its bound is the pair count times 4 * hd over the peak of the input type:
// 989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s for f32 outside them.
//
// Two kernels, chosen by the input type:
//
// * bf16: `tc::fa_tc_kernel`, on the tensor cores.  One CTA of three
//   warpgroups per (128 query rows, q-head, batch), the longest causal
//   q-tiles issued first.  Warpgroup 0 is the producer: its registers are
//   lowered with `setmaxnreg`, and one of its threads issues TMA loads, the
//   Q tile once, then the K and V tiles of the kv-head through a ring of
//   three stages (224 KB at hd 128), each with a full barrier for K, one
//   for V and an empty barrier.  Warpgroups 1 and 2 each own 64 query rows:
//   S = Q K^T by `wgmma` (m64n128k16, both operands K-major in shared
//   memory, 128-byte swizzle), the online softmax on the f32 accumulator in
//   registers (the 1/sqrt(hd) scale applied in f32 after the product,
//   folded with log2 e into exp2, so q is never rounded by a pre-scale),
//   then O += P V by `wgmma` with P converted to bf16 in registers as the A
//   operand and V read from shared memory in its row-major [keys, hd]
//   layout with the transpose bit set.  A consumer issues the next tile's
//   Q K^T before the last tile's P V, and runs the next softmax while P V
//   is on the tensor cores.  O is rescaled by alpha between the two
//   products and divided by l in f32 at the end.  The TMA maps are 4-D
//   over the JAX layout (hd, H, S, B), built per call on the host by
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//   library is not linked against libcuda.  A box is 64 columns (128 bytes,
//   the 128-byte swizzle's span) by 128 rows, so an hd-128 row is two
//   boxes.  Rows past S or T are filled with zeros by TMA, and a key >= T is
//   masked to -inf; only the diagonal, window-edge and ragged tiles are
//   masked, and KV tiles that the causal and window rules rule out are not
//   loaded at all.  P is rounded to bf16 before P V: one rounding more than
//   the f32 path, which the card's gate allows for.
// * f32: `cc::fa_cc_kernel`, on the CUDA cores.  One block of 256 threads
//   per (64 query rows, q-head, batch); the scaled Q tile and each 64-key
//   K/V tile in shared memory; each thread owns 4 rows x 4 keys of the
//   score tile and 4 rows x hd/16 output columns, so m, l and the
//   accumulator stay in registers.  Every product and sum is an f32 one
//   (TF32 would break the f32 gate), pruned and masked as above.

#include <cuda.h>            // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cc {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per staged tile
constexpr int kThreads = 256;    // 16 x 16: rows in groups of 4, cols by 16
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_cc_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int Tk, int Hq, int G, long long qsb, long long qss,
             long long qsh, long long ksb, long long kst, long long ksh,
             long long vsb, long long vst, long long vsh, int causal,
             int window, float scale) {
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    Qs[r * QP + d] = (q0 + r < S) ? qb[(q0 + r) * qss + d] * scale : 0.0f;
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
      Ks[r * QP + d] = in ? kb[(k0 + r) * kst + d] : 0.0f;
      Vs[r * HD + d] = in ? vb[(k0 + r) * vst + d] : 0.0f;
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
    float* o = out + (((long long)b * S + r) * Hq + h) * HD;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[tx + 16 * dd] = acc[i][dd] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int Hq, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  const size_t shmem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_cc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  fa_cc_kernel<HD><<<grid, kThreads, shmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, Tk,
      Hq, Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace cc

namespace tc {

constexpr int kBQ = 128;             // query rows per CTA (64 per consumer)
constexpr int kBK = 128;             // keys per K/V stage
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;   //   = 64512 of the SM's 65536
constexpr int kBoxCols = 64;         // bf16 columns of one 128-byte box
constexpr int kBoxBytes = 128 * kBoxCols * 2;   // 128 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kStages = 3;
  static constexpr int kBoxes = HD / kBoxCols;        // boxes per tile row
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kBars = 1 + 3 * kStages;       // q, k/v full, empty
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + kTileBytes * (1 + 2 * kStages) +
                               8 * kBars;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// Keeps the compiler from moving accesses to `d` across a wgmma, and keeps
// registers that an in-flight wgmma reads live (not reused) until here.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define R32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define R64                                                                  \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "  \
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
      "%58, %59, %60, %61, %62, %63"

// d[64] (+)= A[64x16] B[16x128]; A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[N/2] += A[64x16] B[16xN]; A in registers, B MN-major (transposed) in
// shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F4
#undef F16
#undef R32
#undef R64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ out, int S, int Tk, int Hq, int G,
             int causal, int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(base);
  const uint32_t k_s = q_s + C::kTileBytes;                 // ST tiles
  const uint32_t v_s = k_s + ST * C::kTileBytes;            // ST tiles
  const uint32_t bar = v_s + ST * C::kTileBytes;            // 8 bytes each
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * ST + s); };

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq, hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;        // longest first
  const int nkv = (Tk + kBK - 1) / kBK;
  int hi = nkv;
  if (causal) hi = min(nkv, (q0 + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;
  const int n = max(hi - lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (t == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(q_s + c * kBoxBytes, &qmap, q_full, c * kBoxCols, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % ST, k0 = (lo + it) * kBK;
        mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(k_s + s * C::kTileBytes + c * kBoxBytes, &kmap, k_full(s),
                   c * kBoxCols, hk, k0, b);
        mbar_expect_tx(v_full(s), C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(v_s + s * C::kTileBytes + c * kBoxBytes, &vmap, v_full(s),
                   c * kBoxCols, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1, warp = t / 32, lane = t % 32;
    const int row_lo = q0 + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4;   // d[4j], d[4j+1]; +8 for
    const int c0 = 2 * (lane % 4);                  // d[4j+2], d[4j+3]
    float o[HD / 2], s[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    // This consumer's 64 rows start 64 x 128 bytes into each Q box.
    const uint32_t qa = q_s + 64 * 128 * cw;

    // O += P V for the tile in stage `sp`: V [keys, hd] read transposed;
    // 16 keys = 2048 bytes a step, the next 64 columns of hd one box on
    auto issue_pv = [&](int sp) {
      const uint32_t va = v_s + sp * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_rs(o, pa[kk], desc(va + kk * 2048, kBoxBytes, 1024));
    };

    // Per tile j: issue S_j = Q K_j^T, then P_{j-1} V_{j-1}; wait for S_j
    // alone and run its softmax while P V runs; then rescale O and pack P_j.
    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % ST, k0 = (lo + it) * kBK;
      const int sp = (it + ST - 1) % ST;            // stage of tile it - 1
      const uint32_t ka = k_s + st * C::kTileBytes;

      // S = Q K^T: hd / 16 steps of 32 bytes along each 128-byte row
      mbar_wait(k_full(st), (it / ST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        mma_ss_n128(s, desc(qa + off, 16, 1024), desc(ka + off, 16, 1024),
                    kk > 0);
      }
      wg_commit();
      if (it > 0) {
        mbar_wait(v_full(sp), ((it - 1) / ST) & 1);
        issue_pv(sp);
        wg_commit();
      }
      if (it > 0) wg_wait1(); else wg_wait0();
      reg_fence(s);

      // mask the diagonal, window-edge and ragged tiles only
      const bool need = k0 + kBK > Tk || (causal && k0 + kBK - 1 > row_lo) ||
                        (window > 0 && row_lo + 63 - k0 >= window);
      if (need) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + 8 * (i / 4) + c0 + (i & 1);
          const int row = r0 + 8 * ((i >> 1) & 1);
          const bool vis = col < Tk && (!causal || col <= row) &&
                           (window <= 0 || row - col < window);
          if (!vis) s[i] = -INFINITY;
        }
      }

      // online softmax in f32: scores scaled by log2(e) / sqrt(hd) here
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      const float n0 = x0 == -INFINITY ? 0.0f : x0 * scale_log2;
      const float n1 = x1 == -INFINITY ? 0.0f : x1 * scale_log2;
      const float a0 = ex2(m0 * scale_log2 - n0);
      const float a1 = ex2(m1 * scale_log2 - n1);
      m0 = x0;
      m1 = x1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -n0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -n0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -n1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -n1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;       // this thread's share of the row sum
      l1 = l1 * a1 + sum1;

      // P_{j-1} V_{j-1} done: its stage is free, and O and the P registers
      // may be written (the fences keep pa live, and unwritten, until here)
      wg_wait0();
      reg_fence(o);
      reg_fence(pa);
      reg_fence(s);
      if (it > 0) mbar_arrive(empty(sp));
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      // P in bf16 as wgmma A fragments: key step kk is accumulator
      // columns 16 kk .. 16 kk + 15, i.e. s[8 kk .. 8 kk + 7]
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }
    if (n > 0) {                 // the last tile's P V
      const int sl = (n - 1) % ST;
      mbar_wait(v_full(sl), ((n - 1) / ST) & 1);
      wg_fence();
      issue_pv(sl);
      wg_commit();
      wg_wait0();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty(sl));
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float i1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* o0 = out + (((long long)b * S + r0) * Hq + h) * HD + c0;
    __nv_bfloat16* o1 = o0 + (long long)8 * Hq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map over [B, L, H, hd] (strides in elements) as (hd, H, L, B), boxes
// of 64 columns x 1 head x 128 rows x 1 batch, 128-byte swizzle, zeros past
// the edges.  Returns a CUresult (0 on success).
int make_map(CUtensorMap* map, EncodeTiled fn, const void* ptr, int hd, int H,
             int L, int B, long long sb, long long sl, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, 128, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)ptr, dims,
                 strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes past CUDA's: the driver entry point is missing, or a map was
// refused (kMapError + the CUresult).
constexpr int kNoEntryPoint = 10000;
constexpr int kMapError = 20000;

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int Hq, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kNoEntryPoint;
  CUtensorMap qm, km, vm;
  int r = make_map(&qm, fn, q, HD, Hq, S, B, st[0], st[1], st[2]);
  if (r == 0) r = make_map(&km, fn, k, HD, Hkv, Tk, B, st[3], st[4], st[5]);
  if (r == 0) r = make_map(&vm, fn, v, HD, Hkv, Tk, B, st[6], st[7], st[8]);
  if (r != 0) return kMapError + r;
  const int shmem = Cfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq * B, (S + kBQ - 1) / kBQ);
  fa_tc_kernel<HD><<<grid, kThreads, shmem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, S, Tk, Hq, Hq / Hkv, causal, window,
      kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// strides: q (b, s, h), k (b, t, h), v (b, t, h) in elements.  Launch on
// `stream`; return cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for a head dim they do not take, or (bf16) one of tc's codes above.

// f32 inputs, the CUDA-core kernel.
int flash_attention_cc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int Tk, int Hq,
                              int Hkv, int hd, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, long long vsb, long long vst,
                              long long vsh, int causal, int window,
                              void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return 0;
  if (hd == 64)
    return cc::launch<64>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                          window, s);
  if (hd == 128)
    return cc::launch<128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                           window, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 inputs, the tensor-core kernel.  Base addresses and strides must be
// 16-byte aligned (the wrapper checks).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int Tk, int Hq,
                              int Hkv, int hd, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, long long vsb, long long vst,
                              long long vsh, int causal, int window,
                              void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return 0;
  if (hd == 64)
    return tc::launch<64>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                          window, s);
  if (hd == 128)
    return tc::launch<128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                           window, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel's shape at head dim `hd`: threads, producer and
// consumer registers (setmaxnreg), K/V stages, dynamic shared memory bytes.
int flash_attention_tc_info(int hd, int* info) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  info[0] = tc::kThreads;
  info[1] = tc::kProducerRegs;
  info[2] = tc::kConsumerRegs;
  info[3] = hd == 64 ? tc::Cfg<64>::kStages : tc::Cfg<128>::kStages;
  info[4] = hd == 64 ? tc::Cfg<64>::kSmem : tc::Cfg<128>::kSmem;
  return 0;
}

}  // extern "C"
