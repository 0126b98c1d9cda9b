// flash_attention: blocked online-softmax attention for Hopper.
//
// Replaces the TPU Pallas kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention`).
//
// What it computes.  q [B, S, Hq, hd], k [B, T, Hkv, hd], v [B, T, Hkv, hv]
// -> out [B, S, Hq*hv], scores scaled by 1/sqrt(hd): query row i sees key j
// iff j <= i (causal), i - j < window (window > 0) and j < T; q-head h reads
// kv-head h / G with G = Hq / Hkv (GQA).  (hd, hv) is (64, 64) or
// (128, 128) on both paths and, on the bf16 path, also latent attention's
// (192, 128): DeepSeek-V3's prompt, whose keys are 128 up-projected and 64
// roped columns and whose values are 128 wide.  Inputs are read through
// their strides in the JAX layout (no transposes; the head dim must be
// contiguous); the output has the input's type.  A query row that sees no
// key at all (only possible with a window and S > T) is left at zero, where
// the dense reference averages V; the LM never asks for one.
//
// What bounds it on this card.  Operations: 2 * (hd + hv) per visible
// (query, key) pair (hd multiply-adds in Q K^T, hv in P V) against about
// (hd + hv) * (S + T) elements of input, far above the ~295 bf16
// tensor-core operations the H100 does per byte of HBM.  Its bound is the
// pair count times 2 * (hd + hv) over the peak of the route: 989 TFLOP/s
// for bf16 on the tensor cores; for f32, three TF32 products per f32 one
// (below) over the 495 TFLOP/s TF32 peak, i.e. 165 TFLOP/s of f32 work
// (the 67 TFLOP/s of f32 outside the tensor cores is the old route's).
//
// Two kernels, chosen by the input type, both on the tensor cores and both
// reading q, k and v through 4-D TMA maps over the JAX layout (hd, H, S, B),
// built per call on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library is not linked against libcuda.  A
// box is 128 bytes of columns (the 128-byte swizzle's span) by a tile's
// rows; rows past S or T are filled with zeros by TMA, and a key >= T is
// masked to -inf; only the diagonal, window-edge and ragged tiles are
// masked, and KV tiles that the causal and window rules rule out are not
// loaded at all.  The longest causal q-tiles are launched first: of all heads
// at once, except in the bf16 kernel's <192,128>, which takes a group of
// heads at a time (below).
//
// * bf16: `tc::fa_tc_kernel`.  One CTA of three warpgroups per (128 query
//   rows, q-head, batch), templated on (hd, hv) as <DQK, DV>.  The grid is
//   (pairs of a group, q-tiles, groups): a group of (batch, q-head) pairs
//   at a time, the pairs fastest and the q-tiles longest first.  At
//   <64,64> and <128,128> one group holds every pair, the grid the f32
//   kernel's.  At <192,128> a group holds as many kv-heads as keep their
//   K/V within half the L2 (`head_group`, the L2's size read once a
//   device), so the ~132 blocks in flight read K/V tiles that L2 holds;
//   where all K/V fit, one group is every pair.  A long prompt's K/V
//   outgrow the 50 MB L2 (270 MB at
//   [4, 6592, 16 heads, 192/128]): in one group the blocks in flight
//   spanned every head and each q-tile read its K/V prefix from HBM,
//   7.1 GB or 2.1 ms at 3.35 TB/s, what that shape took (2.01-2.30 ms);
//   in groups of 6 heads it takes 1.34-1.45 ms, against a 0.90 ms bound
//   (H100 80GB HBM3 at 700 W).  The same order numbered in one dimension
//   ran 12-16% slower than the 2-D grid at [2, 4096, 32/8, 64], whose K/V
//   fit.  Warpgroup 0 is the producer: its registers are lowered with
//   `setmaxnreg`, and one of its threads starts TMA loads, the Q tile once,
//   then the K and V tiles of the kv-head through a ring of stages, each
//   with a full barrier for K, one for V and an empty barrier.  The ring
//   takes as many 128-key stages as fit beside the Q tile in the 232,448
//   bytes a block may use, at most three: three at <64,64> (113 KB) and
//   <128,128> (225 KB); two at <192,128> (209 KB: a 48 KB Q tile, 48 KB of
//   K and 32 KB of V a stage; three would take 289 KB).  With two stages a
//   stage's K and V are freed apart, K by a barrier of its own once its
//   Q K^T is done, so the producer loads the next K tile but one while
//   this tile's softmax and P V run, as a third stage would let it; with
//   one shared barrier it could load only after the last P V, and every
//   tile waited a load: 15-25% slower from 1168 tokens up (1.67-1.78 ms
//   against 1.37-1.41 ms at [4, 6592]).  A 64-key stage would give
//   <192,128> three stages, but would halve S's accumulator and the keys
//   a P V step; it was not tried.
//   Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by `wgmma`
//   (m64n128k16, both operands K-major in shared memory, 128-byte swizzle;
//   hd / 16 k-steps, 12 at hd 192, into the same 64 f32 accumulators a
//   thread), the online softmax on the f32 accumulator in registers (the
//   1/sqrt(hd) scale applied in f32 after the product, folded with log2 e
//   into exp2, so q is never rounded by a pre-scale), then O += P V by
//   `wgmma` with P converted to bf16 in registers as the A operand and V
//   read from shared memory in its row-major [keys, hv] layout with the
//   transpose bit set.  A consumer starts the next tile's Q K^T before the
//   last tile's P V, and runs the next softmax while P V is on the tensor
//   cores.  O is rescaled by alpha between the two products and divided by
//   l in f32 at the end.  A box is 64 columns by 128 rows, so an hd-128 row
//   is two boxes and an hd-192 row three.  O is hv / 2 f32 registers a
//   thread, so <192,128>'s consumer holds what <128,128>'s does (o[64],
//   s[64], P in 8 x 4 registers) and keeps its register split.  P is
//   rounded to bf16 before P V, as DeepSeek-V3's published modeling code
//   casts the softmax to the query's type before the value product: one
//   rounding more than the f32 path, which the card's gate allows for.
// * f32: `tf::fa_tf32_kernel`, 3xTF32 on the tensor cores.  It replaces a
//   CUDA-core kernel that reached 21% of the 67 TFLOP/s f32 bound: its
//   inner products were held by shared-memory loads (8 loads a 16 FMAs),
//   one 8-warp block filled an SM and its K/V loads did not overlap its
//   compute.  One TF32 product keeps 11 bits of each operand and misses the
//   f32 gate (2e-5 + 2e-5 |plain|) by 26-41x at unit-normal inputs, so each
//   operand is split, x = hi + lo with hi = x rounded to TF32 (to nearest,
//   ties away, as cvt.rna.tf32.f32 rounds, but by integer ops on the bits,
//   which issue faster than the conversion) and lo = x - hi rounded so, and
//   a product is the sum hi lo + lo hi + hi hi, each 8-wide k-step's small
//   terms before its big one.  Emulated on the CPU
//   (tests/test_torch_flash_f32.py) that is as exact as f32 arithmetic;
//   on the card its error against an f64 attention stays within twice the
//   plain twin's, also at scores of std 16 and 32, where no f32 kernel
//   holds the gate against the twin.  The tensor cores add in f32 with
//   their own alignment and truncation, not IEEE rounding, so a product is
//   summed on them only over a short run (kRun k-steps of Q K^T, one key
//   tile of P V) and then added to its f32 accumulator by an FADD or FMA.
//   Route: `wgmma` m64nNk8 .tf32, whose B operand (and A, where in shared
//   memory) must be K-major.  One block of two warpgroups per (128 query
//   rows, q-head, batch), 64 rows a warpgroup; 32-key K/V tiles through a
//   ring of two stages filled by TMA on an mbarrier each.  Q stays raw in
//   shared memory: each k-step's A fragments are read by `ldmatrix` and
//   split in registers, so Q is read once a k-step rather than by three
//   wgmmas, which leaves room for a split pass per tile that turns the raw
//   K and V into what wgmma reads: K hi in place and K lo beside it (K is
//   K-major as landed), and V transposed to V^T hi and lo [hd][keys] (keys
//   contiguous, the 128-byte swizzle written by hand).  S = Q K^T is
//   `wgmma` m64n32k8 (Q lo K hi, Q hi K lo, Q hi K hi), runs summed into
//   two register sets by turns so one run is on the tensor cores while the
//   last is added.  P stays in registers: P V's k index t stands for key
//   2t of an 8-key step and t + 4 for key 2t + 1 (the split pass writes V^T
//   in that order), so S's accumulator layout is P's A-fragment layout, and
//   O += P V is `wgmma` m64n{hd}k8 with P hi and lo from registers.  While
//   a tile's P V is on the tensor cores the block splits the next tile
//   (whose stage and split tiles are its own), inside the same branch as
//   the wgmma so that ptxas keeps the accumulator in flight.  The online
//   softmax is the bf16 kernel's, in f32 registers, the scale applied after
//   the product.  A warpgroup skips a tile its rows cannot see.  Shared
//   memory at hd 128: Q 64 KB, the raw ring 64 KB, K lo, V^T hi and V^T lo
//   for each stage 96 KB (225 KB with the alignment slack, one block an
//   SM).  What bounds it next: the softmax between the products leaves the
//   tensor cores idle, and 255 registers a thread leave no room to issue
//   the next tile's Q K^T before this tile's P V.

#include <cuda.h>            // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace tc {

constexpr int kBQ = 128;             // query rows per CTA (64 per consumer)
constexpr int kBK = 128;             // keys per K/V stage
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;   //   = 64512 of the SM's 65536
constexpr int kBoxCols = 64;         // bf16 columns of one 128-byte box
constexpr int kBoxBytes = 128 * kBoxCols * 2;   // 128 rows x 128 bytes
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// The kernel at a Q K^T depth DQK and a V width DV (64 columns a box).  The
// K/V ring takes as many stages as fit beside the Q tile, at most three:
// three at <64,64> and <128,128>, two at <192,128>.  With two stages a
// stage's K and V are released apart (kSplit): K once its Q K^T is done,
// so the next K tile but one lands while this tile's softmax and P V run.
// <192,128> runs its blocks in L2-sized head groups (kGroups, head_group);
// the equal-dims instances launch every pair in one group, as before it.
template <int DQK, int DV>
struct Cfg {
  static constexpr bool kGroups = DQK != DV;
  static constexpr int kQBoxes = DQK / kBoxCols;      // boxes per Q or K row
  static constexpr int kVBoxes = DV / kBoxCols;       // boxes per V row
  static constexpr int kQKBytes = kQBoxes * kBoxBytes;   // a Q or K tile
  static constexpr int kVBytes = kVBoxes * kBoxBytes;    // a V tile
  // stages that fit beside the Q tile, the slack and 13 barriers
  static constexpr int kFit =
      (kSmemMax - 1024 - kQKBytes - 8 * 13) / (kQKBytes + kVBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr bool kSplit = kStages < 3;
  // q; k/v full, empty (V's alone where kSplit); K's empty where kSplit
  static constexpr int kBars = 1 + (kSplit ? 4 : 3) * kStages;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte atom
  static constexpr int kSmem =
      1024 + kQKBytes + kStages * (kQKBytes + kVBytes) + 8 * kBars;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "tiles do not fit");
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ out, int S, int Tk, int Hq, int G,
             int BH, int causal, int window, float scale_log2) {
  using C = Cfg<DQK, DV>;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(base);
  const uint32_t k_s = q_s + C::kQKBytes;                   // ST tiles
  const uint32_t v_s = k_s + ST * C::kQKBytes;              // ST tiles
  const uint32_t bar = v_s + ST * C::kVBytes;               // 8 bytes each
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + ST + s); };
  // the stage free (V's half alone where C::kSplit), and K's half
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * ST + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 3 * ST + s); };

  // Block (x, y, z): (batch, q-head) pair bh = z gridDim.x + x of the BH,
  // q-tile y from the last, so a group of gridDim.x pairs runs at a time,
  // its longest tiles first.
  const int bh = blockIdx.z * gridDim.x + blockIdx.x;
  if (bh >= BH) return;                     // the last group's spare blocks
  const int h = bh % Hq, b = bh / Hq, hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
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
      if constexpr (C::kSplit) mbar_init(k_empty(s), 2 * 128);
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
      mbar_expect_tx(q_full, C::kQKBytes);
#pragma unroll
      for (int c = 0; c < C::kQBoxes; ++c)
        tma_load(q_s + c * kBoxBytes, &qmap, q_full, c * kBoxCols, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % ST, k0 = (lo + it) * kBK;
        const uint32_t free_par = ((it / ST) & 1) ^ 1;
        mbar_wait(C::kSplit ? k_empty(s) : empty(s), free_par);
        mbar_expect_tx(k_full(s), C::kQKBytes);
#pragma unroll
        for (int c = 0; c < C::kQBoxes; ++c)
          tma_load(k_s + s * C::kQKBytes + c * kBoxBytes, &kmap, k_full(s),
                   c * kBoxCols, hk, k0, b);
        if constexpr (C::kSplit) mbar_wait(empty(s), free_par);
        mbar_expect_tx(v_full(s), C::kVBytes);
#pragma unroll
        for (int c = 0; c < C::kVBoxes; ++c)
          tma_load(v_s + s * C::kVBytes + c * kBoxBytes, &vmap, v_full(s),
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
    float o[DV / 2], s[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    // This consumer's 64 rows start 64 x 128 bytes into each Q box.
    const uint32_t qa = q_s + 64 * 128 * cw;

    // O += P V for the tile in stage `sp`: V [keys, DV] read transposed;
    // 16 keys = 2048 bytes a step, the next 64 columns of DV one box on
    auto issue_pv = [&](int sp) {
      const uint32_t va = v_s + sp * C::kVBytes;
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
      const uint32_t ka = k_s + st * C::kQKBytes;

      // S = Q K^T: DQK / 16 steps of 32 bytes along each 128-byte row
      mbar_wait(k_full(st), (it / ST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
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
      if constexpr (C::kSplit) mbar_arrive(k_empty(st));   // K_j read

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

      // online softmax in f32: scores scaled by log2(e) / sqrt(DQK) here
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
      for (int j = 0; j < DV / 8; ++j) {
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
    __nv_bfloat16* o0 = out + (((long long)b * S + r0) * Hq + h) * DV + c0;
    __nv_bfloat16* o1 = o0 + (long long)8 * Hq * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
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

// A 4-D map over [B, L, H, hd] (strides in elements of `size` bytes) as
// (hd, H, L, B), boxes of 128 bytes of columns x 1 head x `rows` rows x 1
// batch, 128-byte swizzle, zeros past the edges.  Returns a CUresult (0 on
// success).
int make_map(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type,
             int size, int rows, const void* ptr, int hd, int H, int L, int B,
             long long sb, long long sl, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * size),
                                 (cuuint64_t)(sl * size),
                                 (cuuint64_t)(sb * size)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / size), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return (int)fn(map, type, 4, (void*)ptr, dims, strides, box, estr,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The current device's L2 bytes, read once a device.
constexpr int kMaxDevices = 64;
int l2_bytes() {
  static std::atomic<int> seen[kMaxDevices];
  int dev = 0, l2 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) l2 = seen[dev].load(std::memory_order_relaxed);
  if (l2 == 0 &&
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) ==
          cudaSuccess &&
      dev < kMaxDevices)
    seen[dev].store(l2, std::memory_order_relaxed);
  return l2;
}

// The (batch, q-head) pairs a group of <192,128>'s blocks takes: as many
// whole kv-heads as keep the K/V they read (kv_bytes a kv-head) within half
// the L2, all BH pairs where everything fits.
int head_group(int BH, int G, long long kv_bytes) {
  const long long l2 = l2_bytes();
  const long long kv_heads = kv_bytes > 0 ? l2 / 2 / kv_bytes : BH;
  const long long pairs = (kv_heads > 1 ? kv_heads : 1) * G;
  return (int)(pairs < BH ? pairs : BH);
}

// Error codes past CUDA's: the driver entry point is missing, or a map was
// refused (kMapError + the CUresult).
constexpr int kNoEntryPoint = 10000;
constexpr int kMapError = 20000;

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int Hq, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kNoEntryPoint;
  CUtensorMap qm, km, vm;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int r = make_map(&qm, fn, bf, 2, kBQ, q, DQK, Hq, S, B, st[0], st[1],
                   st[2]);
  if (r == 0)
    r = make_map(&km, fn, bf, 2, kBK, k, DQK, Hkv, Tk, B, st[3], st[4],
                 st[5]);
  if (r == 0)
    r = make_map(&vm, fn, bf, 2, kBK, v, DV, Hkv, Tk, B, st[6], st[7], st[8]);
  if (r != 0) return kMapError + r;
  const int shmem = Cfg<DQK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shmem);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * Hq;
  const int group =
      Cfg<DQK, DV>::kGroups
          ? head_group(BH, Hq / Hkv, (long long)Tk * (DQK + DV) * 2)
          : BH;
  const dim3 grid(group, (S + kBQ - 1) / kBQ, (BH + group - 1) / group);
  fa_tc_kernel<DQK, DV><<<grid, kThreads, shmem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, S, Tk, Hq, Hq / Hkv, BH, causal,
      window, kLog2e / sqrtf((float)DQK));
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace tf {

constexpr int kBQ = 128;             // query rows per block, 64 a warpgroup
constexpr int kBK = 32;              // keys per K/V stage
constexpr int kThreads = 256;        // two warpgroups
constexpr int kStages = 2;
constexpr int kRun = 2;              // Q K^T k-steps a run on the tensor cores
constexpr int kBoxCols = 32;         // f32 columns of one 128-byte box row
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kBoxes = HD / kBoxCols;        // boxes per tile row
  static constexpr int kQBytes = kBoxes * kBQ * 128;  // the raw Q tile
  static constexpr int kTileBytes = HD * kBK * 4;     // a K or V tile
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte atom;
  // Q, the raw K/V ring, K lo, V^T hi and V^T lo of each stage, the
  // barriers
  static constexpr int kSmem = 1024 + kQBytes + 5 * kStages * kTileBytes +
                               8 * (1 + kStages);
};

// Byte offset of 16-byte chunk `chunk` of row r in rows of 128 bytes that
// TMA's 128-byte swizzle permutes by r mod 8.
__device__ __forceinline__ uint32_t swz_row(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// Byte offset of (row r, column c) in a tile of R rows held as boxes of 32
// columns, one 128-byte swizzled row each.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / kBoxCols) * (R * 128) + swz_row(r, (c % kBoxCols) >> 2) +
         ((c & 3) << 2);
}

// x rounded to TF32 (nearest, ties away from zero): what cvt.rna.tf32.f32
// gives, by integer ops on the bits (add half a TF32 ulp, clear the 13
// dropped bits), which issue at the integer pipe's rate where the
// conversion runs on the slower conversion pipe.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = rna(x), lo = rna(x - hi).  hi * hi is exact in f32,
// and hi * lo + lo * hi carries what one TF32 product drops.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// Returns once the phase of parity `parity` of the barrier has completed;
// traps (a launch error, not a hang) if it has not within ~2 s.
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

template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define R16                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define R32                                                                  \
  R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "  \
      "%29, %30, %31"
#define R64                                                                  \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "  \
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
      "%58, %59, %60, %61, %62, %63"

// Four 8x4 f32 matrices (8x8 in b16 terms): lane l gets word (l / 4, l % 4)
// of each, the rows addressed by lanes 8i..8i+7 for matrix i.
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// d[N/2] (+)= A[64x8] B[8xN], TF32, A in registers, B K-major in shared
// memory (N = 32 for S, hd for O).
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" R16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef F4
#undef F16
#undef R16
#undef R32
#undef R64

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               float* __restrict__ out, int S, int Tk, int Hq, int G,
               int causal, int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int TB = C::kTileBytes;
  constexpr int KU = TB / 16 / kThreads;  // 16-byte units a thread splits
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = tc::smem_u32(base);        // raw Q
  const uint32_t ring = q_s + C::kQBytes;         // per stage: K, then V
  // per stage: K lo, V^T hi, V^T lo
  const uint32_t spl = ring + 2 * kStages * TB;
  const uint32_t bar = spl + 3 * kStages * TB;    // 8 bytes each
  const uint32_t q_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };     // K and V
  auto at = [&](uint32_t a) { return base + (a - q_s); };   // generic

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq, hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;        // longest first
  const int nkv = (Tk + kBK - 1) / kBK;
  int hi = nkv;
  if (causal) hi = min(nkv, (q0 + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;
  const int n = max(hi - lo, 0);
  const int tid = threadIdx.x;

  auto issue = [&](int it) {           // one thread: tile it into its stage
    const int st = it % kStages, k0 = (lo + it) * kBK;
    const uint32_t ks = ring + 2 * st * TB;
    tc::mbar_expect_tx(full(st), 2 * TB);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tc::tma_load(ks + c * kBK * 128, &kmap, full(st), c * kBoxCols, hk, k0,
                   b);
      tc::tma_load(ks + TB + c * kBK * 128, &vmap, full(st), c * kBoxCols,
                   hk, k0, b);
    }
  };
  // Split pass of tile it (all threads): K hi in place and K lo beside it
  // (K is K-major as landed); V transposed to V^T [hd][keys], keys
  // contiguous as wgmma's K-major B wants, in the key order P's registers
  // hold (P V's k index t is key 2t of an 8-key step, t + 4 key 2t + 1),
  // hi and lo beside the raw V.  The split tiles are read by wgmma (the
  // async proxy) and the ring's stage is refilled by TMA, hence the proxy
  // fence.
  auto split_tile = [&](int it) {
    const int st = it % kStages;
    const uint32_t ks = ring + 2 * st * TB, vs = ks + TB;
    const uint32_t kl = spl + 3 * st * TB, vh = kl + TB, vl = vh + TB;
    mbar_wait(full(st), (it / kStages) & 1);
#pragma unroll
    for (int i = 0; i < KU; ++i) {
      const int u = tid + kThreads * i;
      const int col = u % HD, q4 = u / HD;  // V^T row, 16-byte chunk
      const int key0 = 8 * (q4 / 2) + (q4 & 1);
      float4 x;
      x.x = *reinterpret_cast<const float*>(at(vs + swz<kBK>(key0, col)));
      x.y = *reinterpret_cast<const float*>(at(vs + swz<kBK>(key0 + 2, col)));
      x.z = *reinterpret_cast<const float*>(at(vs + swz<kBK>(key0 + 4, col)));
      x.w = *reinterpret_cast<const float*>(at(vs + swz<kBK>(key0 + 6, col)));
      uint4 h4, l4;
      split4(x, h4, l4);
      *reinterpret_cast<uint4*>(at(vh + swz_row(col, q4))) = h4;
      *reinterpret_cast<uint4*>(at(vl + swz_row(col, q4))) = l4;
      const uint32_t off = 16 * u;
      split4(*reinterpret_cast<const float4*>(at(ks + off)), h4, l4);
      *reinterpret_cast<uint4*>(at(ks + off)) = h4;
      *reinterpret_cast<uint4*>(at(kl + off)) = l4;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  if (tid == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) tc::mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tc::tma_load(q_s + c * kBQ * 128, &qmap, q_full, c * kBoxCols, h, q0,
                   b);
    for (int it = 0; it < min(n, kStages); ++it) issue(it);
  }

  const int cw = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 64 * cw;     // this warpgroup's first row
  const int r0 = row_lo + 16 * warp + g;   // rows of d[4j], d[4j+1]; +8
  // ldmatrix row addresses for Q's A fragments: matrix i holds rows + 8
  // (i & 1) and columns + 4 (i >> 1) of the warp's 16 rows
  const int qrow = 64 * cw + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int qcol = 4 * (lane >> 4);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_full, 0);
  if (n > 0) split_tile(0);
  __syncthreads();
  for (int it = 0; it < n; ++it) {
    const int st = it % kStages, k0 = (lo + it) * kBK;
    const uint32_t ks = ring + 2 * st * TB;
    const uint32_t kl = spl + 3 * st * TB, vh = kl + TB, vl = vh + TB;
    // a warpgroup whose rows see no key of this tile skips it
    const bool skip = row_lo >= S || (causal && k0 > row_lo + 63) ||
                      (window > 0 && k0 + kBK - 1 <= row_lo - window);
    if (!skip) {
      // ---- S = Q K^T, 3xTF32: Q's A fragments read raw by ldmatrix and
      // split in registers; runs of kRun k-steps (8 kRun columns of hd),
      // each k-step's small terms before its big one, summed on the tensor
      // cores into ta or tb by turns and then added to s in f32 ----
      constexpr int NR = HD / 8 / kRun;      // runs
      float s[16], ta[16], tb[16];
      uint32_t ah[2][kRun][4], al[2][kRun][4];   // A of a run, by turns
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < NR; ++c) {
        float(&tr)[16] = (c & 1) ? tb : ta;
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          uint32_t raw[4];
          ldsm4(raw, q_s + swz<kBQ>(qrow, 8 * (kRun * c + j) + qcol));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(__uint_as_float(raw[i]), ah[c & 1][j][i], al[c & 1][j][i]);
        }
        tc::wg_fence();
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int kk = kRun * c + j;
          const uint32_t ko = (kk / 4) * (kBK * 128) + (kk % 4) * 32;
          const uint64_t dkh = tc::desc(ks + ko, 16, 1024);
          mma_rs(tr, al[c & 1][j], dkh, j);
          mma_rs(tr, ah[c & 1][j], tc::desc(kl + ko, 16, 1024), 1);
          mma_rs(tr, ah[c & 1][j], dkh, 1);
        }
        tc::wg_commit();
        if (c > 0) {                   // run c - 1 is done: add it
          float(&pr)[16] = (c & 1) ? ta : tb;
          tc::wg_wait1();
          tc::reg_fence(pr);
          reg_fence(ah[(c - 1) & 1]);
          reg_fence(al[(c - 1) & 1]);
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] += pr[i];
        }
      }
      {
        float(&pr)[16] = ((NR - 1) & 1) ? tb : ta;
        tc::wg_wait0();
        tc::reg_fence(pr);
        reg_fence(ah[(NR - 1) & 1]);
        reg_fence(al[(NR - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] += pr[i];
      }

      // mask the diagonal, window-edge and ragged tiles only
      const bool need = k0 + kBK > Tk || (causal && k0 + kBK - 1 > row_lo) ||
                        (window > 0 && row_lo + 63 - k0 >= window);
      if (need) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = r0 + 8 * ((i >> 1) & 1);
          const bool vis = col < Tk && (!causal || col <= row) &&
                           (window <= 0 || row - col < window);
          if (!vis) s[i] = -INFINITY;
        }
      }

      // ---- online softmax in f32: scores scaled by log2(e) / sqrt(hd) ----
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      const float a0 = tc::ex2(m0 * scale_log2 - n0);
      const float a1 = tc::ex2(m1 * scale_log2 - n1);
      m0 = x0;
      m1 = x1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[4 * j] = tc::ex2(fmaf(s[4 * j], scale_log2, -n0));
        s[4 * j + 1] = tc::ex2(fmaf(s[4 * j + 1], scale_log2, -n0));
        s[4 * j + 2] = tc::ex2(fmaf(s[4 * j + 2], scale_log2, -n1));
        s[4 * j + 3] = tc::ex2(fmaf(s[4 * j + 3], scale_log2, -n1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;       // this thread's share of the row sum
      l1 = l1 * a1 + sum1;

      // ---- O = alpha O + P V, 3xTF32: P split in registers as wgmma A
      // fragments (key step kk is accumulator columns 8 kk .. 8 kk + 7,
      // s[4 kk .. 4 kk + 3]), the tile's sum on the tensor cores (each
      // k-step's small terms before its big one), issued here and added to
      // alpha O once the next tile's split pass has run beside it ----
      uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        split(s[4 * kk], ph[kk][0], pl[kk][0]);
        split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      float d[HD / 2];
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint64_t dvh = tc::desc(vh + kk * 32, 16, 1024);
        mma_rs(d, pl[kk], dvh, kk);
        mma_rs(d, ph[kk], tc::desc(vl + kk * 32, 16, 1024), 1);
        mma_rs(d, ph[kk], dvh, 1);
      }
      tc::wg_commit();
      // the next tile's split pass (its stage and split tiles are not this
      // tile's), while this tile's P V is on the tensor cores
      if (it + 1 < n) split_tile(it + 1);
      tc::wg_wait0();
      tc::reg_fence(d);
      reg_fence(ph);
      reg_fence(pl);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] = fmaf(o[4 * j], a0, d[4 * j]);
        o[4 * j + 1] = fmaf(o[4 * j + 1], a0, d[4 * j + 1]);
        o[4 * j + 2] = fmaf(o[4 * j + 2], a1, d[4 * j + 2]);
        o[4 * j + 3] = fmaf(o[4 * j + 3], a1, d[4 * j + 3]);
      }
    } else if (it + 1 < n) {
      split_tile(it + 1);
    }
    __syncthreads();   // this tile is done with, and the next one is split
    if (tid == 0 && it + kStages < n) issue(it + kStages);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float i1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  float* o0 = out + (((long long)b * S + r0) * Hq + h) * HD + 2 * t;
  float* o1 = o0 + (long long)8 * Hq * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < S)
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (r0 + 8 < S)
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int Hq, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  tc::EncodeTiled fn = tc::encode_fn();
  if (fn == nullptr) return tc::kNoEntryPoint;
  CUtensorMap qm, km, vm;
  const CUtensorMapDataType f = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int r = tc::make_map(&qm, fn, f, 4, kBQ, q, HD, Hq, S, B, st[0], st[1],
                       st[2]);
  if (r == 0)
    r = tc::make_map(&km, fn, f, 4, kBK, k, HD, Hkv, Tk, B, st[3], st[4],
                     st[5]);
  if (r == 0)
    r = tc::make_map(&vm, fn, f, 4, kBK, v, HD, Hkv, Tk, B, st[6], st[7],
                     st[8]);
  if (r != 0) return tc::kMapError + r;
  const int shmem = Cfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq * B, (S + kBQ - 1) / kBQ);
  fa_tf32_kernel<HD><<<grid, kThreads, shmem, stream>>>(
      qm, km, vm, (float*)out, S, Tk, Hq, Hq / Hkv, causal, window,
      kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace tf

extern "C" {

// hd, hv: the q/k and the v head dims.  strides: q (b, s, h), k (b, t, h),
// v (b, t, h) in elements.  Launch on `stream`; return cudaGetLastError()
// (0 on success), cudaErrorInvalidValue for a pair of head dims they do not
// take, or one of tc's codes above.

// f32 inputs, the 3xTF32 tensor-core kernel, at hd == hv, 64 or 128.  Base
// addresses and strides must be 16-byte aligned (the wrapper checks).
int flash_attention_tf32_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int Tk, int Hq,
                                int Hkv, int hd, int hv, long long qsb,
                                long long qss, long long qsh, long long ksb,
                                long long kst, long long ksh, long long vsb,
                                long long vst, long long vsh, int causal,
                                int window, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (hd != hv) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  if (hd == 64)
    return tf::launch<64>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                          window, s);
  if (hd == 128)
    return tf::launch<128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                           window, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 inputs, the tensor-core kernel, at the (hd, hv) pairs that
// flash_attention_tc_pairs lists.  Base addresses and strides must be
// 16-byte aligned (the wrapper checks).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int Tk, int Hq,
                              int Hkv, int hd, int hv, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kst, long long ksh, long long vsb,
                              long long vst, long long vsh, int causal,
                              int window, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return 0;
  if (hd == 64 && hv == 64)
    return tc::launch<64, 64>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                              window, s);
  if (hd == 128 && hv == 128)
    return tc::launch<128, 128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                                window, s);
  if (hd == 192 && hv == 128)
    return tc::launch<192, 128>(q, k, v, out, B, S, Tk, Hq, Hkv, st, causal,
                                window, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel's shape at head dims (hd, hv): threads, producer
// and consumer registers (setmaxnreg), K/V stages, dynamic shared memory
// bytes.
int flash_attention_tc_info(int hd, int hv, int* info) {
  int stages, smem;
  if (hd == 64 && hv == 64) {
    stages = tc::Cfg<64, 64>::kStages;
    smem = tc::Cfg<64, 64>::kSmem;
  } else if (hd == 128 && hv == 128) {
    stages = tc::Cfg<128, 128>::kStages;
    smem = tc::Cfg<128, 128>::kSmem;
  } else if (hd == 192 && hv == 128) {
    stages = tc::Cfg<192, 128>::kStages;
    smem = tc::Cfg<192, 128>::kSmem;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  info[0] = tc::kThreads;
  info[1] = tc::kProducerRegs;
  info[2] = tc::kConsumerRegs;
  info[3] = stages;
  info[4] = smem;
  return 0;
}

// The (hd, hv) pairs the tensor-core kernel is built at, as 2 x n ints
// (at most `n` pairs) in `pairs`; returns their number.  Builds whose
// launches take a single head dim lack this function.
int flash_attention_tc_pairs(int* pairs, int n) {
  const int all[3][2] = {{64, 64}, {128, 128}, {192, 128}};
  for (int i = 0; i < 3 && i < n; ++i) {
    pairs[2 * i] = all[i][0];
    pairs[2 * i + 1] = all[i][1];
  }
  return 3;
}

// The 3xTF32 kernel's shape at head dim `hd`: threads, keys a K/V tile,
// K/V stages, dynamic shared memory bytes.
int flash_attention_tf32_info(int hd, int* info) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  info[0] = tf::kThreads;
  info[1] = tf::kBK;
  info[2] = tf::kStages;
  info[3] = hd == 64 ? tf::Cfg<64>::kSmem : tf::Cfg<128>::kSmem;
  return 0;
}

}  // extern "C"
