// fusion_eval: per-group decomposition of layer-fusion strategies, for Hopper.
//
// Replaces the TPU Pallas kernel `_fe_kernel` in src/repro/kernels/fusion_eval.py
// (launched by `_fusion_eval_grid_jit`), and the `_probe` lowering probe of
// `compiled_backend_supported` in the same file.
//
// What it computes.  For each condition c and candidate strategy p it sweeps
// chain positions 1..n[c] in order, cutting fused groups at SYNC (-1), and
// accumulates per group: compute seconds, off-chip bytes, on-chip bytes,
// staged-activation bytes, micro-batch waves and member count.  A group of
// one member takes the single-layer streaming terms (one full-batch pass, its
// working set clamped to the streaming buffer); a residual edge is held inside
// its group or crosses groups for 2*B*A of traffic.  A and W are rescaled from
// the pack-time bytes/elem to the hw row's in-kernel.  Outputs C_g, T_g, O_g,
// M_g, wave_g, glen (f32) and gid (i32), each [C, POP, P]; the roofline
// reduction (cost_model.finalize_groups) runs outside the kernel.
//
// What bounds it on this card.  Each (candidate, position) moves 4 bytes of
// strategy in and 28 bytes of outputs out, against a few dozen f32 operations:
// far below the H100's ~20 operations per byte, so by its work it is
// memory-bound: ~10 MB at the main path's shape (120 x 40 x 64), a bound of
// ~3 us, about what one launch costs, so it is launch-bound too.  Measured on
// an H100 it takes ~40 us of device time there: with 40 candidates per
// condition only 4800 threads run, each a dependent 64-step chain.
//
// What the design does about it.  One CUDA block per (condition, tile of 128
// candidates), one thread per candidate.  The condition's layer table and hw
// row are read once per block into shared memory; each thread keeps the open
// group's accumulators in registers and writes a group straight to column
// `scount` when it closes, so nothing but the strategy is read and nothing but
// the outputs written.  The per-thread row writes are uncoalesced (thread p
// writes row p, 256 bytes apart); transposing the tile through shared memory
// to coalesce them is left for later.
//
// Numerics.  Every expression keeps the operation order of the reference
// (fusion_eval.py:128-142) and of the plain twin in fusion_eval.py of this
// package; built with -fmad=false, no multiply-add is contracted, so on the
// card the kernel and the twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kUtilMin = 1.0f / 4096.0f;
constexpr int kHwDim = 10;
// HW_FIELDS slots (core/accel.py)
constexpr int kNpe = 0, kLanes = 1, kFreq = 2, kBpe = 6, kStream = 9;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void fusion_eval_kernel(
    const int32_t* __restrict__ strat,   // [C, POP, P]
    const float* __restrict__ A_g, const float* __restrict__ W_g,
    const float* __restrict__ F_g, const float* __restrict__ OE_g,
    const float* __restrict__ UC_g,      // [C, P]
    const int32_t* __restrict__ SKIP_g,  // [C, P]
    const int32_t* __restrict__ n_g,     // [C]
    const float* __restrict__ batch_g,   // [C]
    const float* __restrict__ bpe_g,     // [C]
    const float* __restrict__ hw_g,      // [C, 10]
    float* __restrict__ Cg, float* __restrict__ Tg, float* __restrict__ Og,
    float* __restrict__ Mg, float* __restrict__ Wg, float* __restrict__ Lg,
    int32_t* __restrict__ gid, int POP, int P) {
  extern __shared__ float smem[];
  float* A = smem;
  float* W = A + P;
  float* F = W + P;
  float* OE = F + P;
  float* UC = OE + P;
  int32_t* SKIP = reinterpret_cast<int32_t*>(UC + P);

  const int c = blockIdx.y;
  const float* hw = hw_g + (size_t)c * kHwDim;
  const float scale = hw[kBpe] / bpe_g[c];
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const size_t k = (size_t)c * P + i;
    A[i] = A_g[k] * scale;
    W[i] = W_g[k] * scale;
    F[i] = F_g[k];
    OE[i] = OE_g[k];
    UC[i] = UC_g[k];
    SKIP[i] = SKIP_g[k];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= POP) return;

  const float B = batch_g[c];
  const float lanes = hw[kNpe] * hw[kLanes];
  const float peak_macs = lanes * hw[kFreq];
  const float stream_buf = hw[kStream];
  const int n = min(n_g[c], P - 1);

  const size_t row = ((size_t)c * POP + p) * P;
  const int32_t* s = strat + row;
  float* oC = Cg + row;
  float* oT = Tg + row;
  float* oO = Og + row;
  float* oM = Mg + row;
  float* oW = Wg + row;
  float* oL = Lg + row;
  int32_t* og = gid + row;

  float g_comp = 0.f, g_traf = 0.f, g_on = 0.f, g_mem = 0.f, g_wav = 0.f,
        g_len = 0.f;
  int scount = 0;       // syncs before position i
  int ncols = 0;        // group columns written so far
  bool prev_sync = false;
  float prev_mb = clipf((float)s[0], 1.0f, B);
  float lastb = -1.0f;  // last sync position
  og[0] = 0;

  for (int i = 1; i <= n; ++i) {
    const float a = (float)s[i];
    const float Ai = A[i], Ap = A[i - 1], Wi = W[i], Fi = F[i];
    const float OEi = OE[i], UCi = UC[i];
    const int src = SKIP[i];
    og[i] = scount;
    const bool sync = a < 0.0f;
    const float mb = clipf(a, 1.0f, B);
    const float mbe = sync ? (prev_sync ? 1.0f : prev_mb) : mb;
    const float stage = sync ? 1.0f : mb;
    const bool head = g_len == 0.0f;

    const bool has_skip = src >= 0;
    const bool same = has_skip && ((float)src > lastb);
    const float Asrc = A[min(max(src, 0), P - 1)];
    const float hold = same ? mbe * Asrc : 0.0f;
    const float cross_t = (has_skip && !same) ? 2.0f * B * Asrc : 0.0f;

    const bool is_tail = sync || (i == n);
    const float waves = ceilf(B / mbe);
    const float head_f = head ? 1.0f : 0.0f;
    const float tail_f = is_tail ? 1.0f : 0.0f;
    const float mem_i = stage * Ai + (head_f * mbe) * Ap + hold;
    const float traf_i =
        (head_f * B) * Ap + (tail_f * B) * Ai + Wi * waves + cross_t;
    const float comp_i =
        B * Fi / peak_macs / clipf(mbe * OEi / lanes, kUtilMin, UCi);
    const float on_i = B * (Ap + Ai) + Wi * waves;

    g_comp = g_comp + comp_i;
    g_traf = g_traf + traf_i;
    g_on = g_on + on_i;
    g_mem = g_mem + mem_i;
    g_wav = g_wav + waves;
    g_len = g_len + 1.0f;

    if (is_tail) {
      if (g_len == 1.0f) {
        // streaming alternative: this layer alone in its group
        const float hold_a = same ? B * Asrc : 0.0f;
        oM[ncols] = fminf(stage * Ai + (head_f * B) * Ap + hold_a, stream_buf);
        oC[ncols] = B * Fi / peak_macs / clipf(B * OEi / lanes, kUtilMin, UCi);
        oT[ncols] = (head_f * B) * Ap + (tail_f * B) * Ai + Wi * 1.0f + cross_t;
        oO[ncols] = B * (Ap + Ai) + Wi * 1.0f;
        oW[ncols] = 1.0f;
      } else {
        oC[ncols] = g_comp;
        oT[ncols] = g_traf;
        oO[ncols] = g_on;
        oM[ncols] = g_mem;
        oW[ncols] = g_wav;
      }
      oL[ncols] = g_len;
      ++ncols;
      g_comp = g_traf = g_on = g_mem = g_wav = g_len = 0.0f;
    }
    if (sync) {
      ++scount;
      lastb = (float)i;
    }
    prev_sync = sync;
    prev_mb = mb;
  }
  for (int i = (n < 0 ? 0 : n) + 1; i < P; ++i) og[i] = scount;
  for (int g = ncols; g < P; ++g) {
    oC[g] = 0.0f; oT[g] = 0.0f; oO[g] = 0.0f;
    oM[g] = 0.0f; oW[g] = 0.0f; oL[g] = 0.0f;
  }
}

__global__ void probe_kernel(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int fusion_eval_launch(const void* strat, const void* A, const void* W,
                       const void* F, const void* OE, const void* UC,
                       const void* SKIP, const void* n, const void* batch,
                       const void* bpe, const void* hw, void* Cg, void* Tg,
                       void* Og, void* Mg, void* Wg, void* Lg, void* gid,
                       int C, int POP, int P, int threads, void* stream) {
  dim3 grid((POP + threads - 1) / threads, C);
  size_t shmem = (size_t)P * (5 * sizeof(float) + sizeof(int32_t));
  fusion_eval_kernel<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (const int32_t*)strat, (const float*)A, (const float*)W,
      (const float*)F, (const float*)OE, (const float*)UC,
      (const int32_t*)SKIP, (const int32_t*)n, (const float*)batch,
      (const float*)bpe, (const float*)hw, (float*)Cg, (float*)Tg,
      (float*)Og, (float*)Mg, (float*)Wg, (float*)Lg, (int32_t*)gid, POP, P);
  return (int)cudaGetLastError();
}

int fusion_eval_probe(void* x, int n, void* stream) {
  probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>((float*)x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
