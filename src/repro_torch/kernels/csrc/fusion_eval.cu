// fusion_eval: costs of layer-fusion strategies, for Hopper.
//
// Replaces the TPU Pallas kernel `_fe_kernel` in src/repro/kernels/fusion_eval.py
// (launched by `_fusion_eval_grid_jit`) together with the CostOut reduction
// that follows it in the same jit (`cost_model.finalize_groups`), and the
// `_probe` lowering probe of `compiled_backend_supported` in the same file.
//
// What it computes.  For each condition c and candidate strategy p it sweeps
// chain positions 1..n[c] in order, cutting fused groups at SYNC (-1), and
// accumulates per group: compute seconds, off-chip bytes, on-chip bytes,
// staged-activation bytes, micro-batch waves and member count.  A group of
// one member takes the single-layer streaming terms (one full-batch pass, its
// working set clamped to the streaming buffer); a residual edge is held inside
// its group or crosses groups for 2*B*A of traffic.  A and W are rescaled from
// the pack-time bytes/elem to the hw row's in-kernel.  Every launch writes the
// candidate's CostOut ([C, POP] each): latency (the roofline time of each
// group summed in group order), peak memory (the largest group's), traffic
// (summed in group order), valid (peak <= budget) and the group count.  The
// group matrices C_g, T_g, O_g, M_g, wave_g, glen (f32) and gid (i32), each
// [C, POP, P], are written only where the caller passes a pointer: none for
// the cost form, gid and M_g for the stats form, all seven for the raw form.
//
// What bounds it on this card.  Per (candidate, position) it reads 4 bytes of
// strategy and, in the stats form, writes 8 bytes, against a few dozen f32
// operations (three IEEE divisions among them): ~1 us of memory traffic at
// the main path's shapes ([120 x 36..40 x 64]), so in practice it is bound
// by a launch, one round trip to device memory, and the instructions and
// dependent steps of the sweep; the sums within a group, and over the
// groups, are serial by contract.
//
// What the design does about it.  One 128-thread block per (condition, tile
// of `tile` candidates); the host sizes the tile so that small populations
// still spread over every SM.  The block copies the condition's layer table
// and its strategy tile to shared memory in one round of coalesced loads.
// Then a warp takes a candidate row end to end, 32 positions at a time: a
// ballot over the SYNC flags gives each lane the last SYNC before it (the
// residual test), its group id (a prefix popcount) and whether it closes a
// group, so every per-position term, divisions included, is computed
// position-parallel and staged in shared memory.  The lane at each group's
// head then sums that group's terms in position order (groups are
// independent, so they are summed side by side) and computes its roofline
// time (two divisions).  Last, one thread per candidate sums the groups in
// group order into the CostOut, and the block writes the matrices the form
// asks for as whole rows.
//
// Numerics.  Every expression keeps the operation order of the reference
// (fusion_eval.py:128-142, cost_model.finalize_groups) and of the plain twin
// in fusion_eval.py of this package; built with -fmad=false, no
// multiply-add is contracted, so on the card the kernel and the twin agree
// bit for bit on every output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kUtilMin = 1.0f / 4096.0f;
constexpr int kHwDim = 10;
// HW_FIELDS slots (core/accel.py)
constexpr int kNpe = 0, kLanes = 1, kFreq = 2, kBwOff = 3, kBwOn = 4,
              kBpe = 6, kTPass = 7, kTSync = 8, kStream = 9;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMats = 6;  // C_g T_g O_g M_g wave_g glen
constexpr int kStep = 8;  // groups a thread loads at once in the CostOut sum

struct Args {
  const int32_t* strat;                       // [C, POP, P]
  const float *A, *W, *F, *OE, *UC;           // [C, P]
  const int32_t* skip;                        // [C, P]
  const int32_t* n;                           // [C]
  const float *batch, *bpe, *hw, *budget;     // [C], [C], [C, 10], [C]
  float *lat, *peak, *traf;                   // [C, POP]
  uint8_t* valid;                             // [C, POP] (torch.bool)
  int32_t* ngroups;                           // [C, POP]
  int32_t* gid;                               // [C, POP, P] or null
  float* mats[kMats];                         // [C, POP, P] each, or null
  int POP, P, tile;
};

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.maximum: NaN when either side is NaN
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Shared memory: the layer table as it is in device memory (6 rows of P
// words), the strategy tile [tile][P], then per candidate row (stride P + 1)
// five arrays of per-position terms, six of per-group values (C, T, O, M,
// wave, length) and one of the groups' roofline times, the tail bit masks,
// the group counts, and kStep words of padding for the blocked loads of the
// last row, which read up to kStep - 1 slots past it.
__host__ __device__ inline size_t smem_bytes(int P, int tile) {
  const int nw = (P + 31) / 32;
  return sizeof(float) * ((size_t)6 * P + (size_t)tile * P +
                          (size_t)12 * tile * (P + 1) + (size_t)tile * nw +
                          tile + kStep);
}

__global__ void __launch_bounds__(kThreads) fusion_eval_kernel(const Args a) {
  extern __shared__ float smem[];
  const int P = a.P, PS = P + 1, T = a.tile, NW = (P + 31) >> 5;
  const int TS = T * PS;
  const int c = blockIdx.y, p0 = blockIdx.x * T;
  const int rows = min(T, a.POP - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* tA = smem;
  float* tW = tA + P;
  float* tF = tW + P;
  float* tOE = tF + P;
  float* tUC = tOE + P;
  int* tSK = reinterpret_cast<int*>(tUC + P);
  int* tS = tSK + P;                // strategy tile [T][P]
  float* term = reinterpret_cast<float*>(tS + T * P);  // [5][T][PS]
  float* gcol = term + 5 * TS;      // [6][T][PS]
  float* lg = gcol + 6 * TS;        // [T][PS]
  uint32_t* tmask = reinterpret_cast<uint32_t*>(lg + TS);  // [T][NW]
  int* ncols = reinterpret_cast<int*>(tmask + T * NW);     // [T]

  // -- 1. the block's loads, copied as they are: one round trip ------------
  const float* hw = a.hw + (size_t)c * kHwDim;
  const float B = a.batch[c];
  const float npe = hw[kNpe], nlanes = hw[kLanes], freq = hw[kFreq];
  const float stream_buf = hw[kStream], bpe_hw = hw[kBpe], bpe = a.bpe[c];
  const float bw_off = hw[kBwOff], bw_on = hw[kBwOn];
  const float t_pass = hw[kTPass], t_sync = hw[kTSync];
  const int n = min(a.n[c], P - 1);
  const int32_t* stile = a.strat + ((size_t)c * a.POP + p0) * P;
#pragma unroll 4
  for (int e = tid; e < rows * P; e += kThreads) tS[e] = stile[e];
  for (int i = tid; i < P; i += kThreads) {
    const size_t k = (size_t)c * P + i;
    tA[i] = a.A[k];
    tW[i] = a.W[k];
    tF[i] = a.F[k];
    tOE[i] = a.OE[k];
    tUC[i] = a.UC[k];
    tSK[i] = a.skip[k];
  }
  const float lanes = npe * nlanes;
  const float peak_macs = lanes * freq;
  const float scale = bpe_hw / bpe;
  __syncthreads();

  // -- 2.-3. a warp a candidate row: its terms, then its groups ------------
  for (int r = warp; r < rows; r += kWarps) {
    const int* s = tS + r * P;
    int32_t* gid_row =
        a.gid ? a.gid + ((size_t)c * a.POP + p0 + r) * P : nullptr;
    uint32_t* tm = tmask + r * NW;
    float* x = term + r * PS;       // array k at x + k * TS
    float* gv = gcol + r * PS;      // array k at gv + k * TS
    float* lr = lg + r * PS;

    // -- 2. per-position terms, 32 positions at a time ----------------------
    int last = -1;          // last SYNC before this chunk
    int cnt = 0;            // SYNCs before this chunk
    bool sync_top = false;  // SYNC at the position before this chunk
    for (int base = 0, w = 0; base < P; base += 32, ++w) {
      const int i = base + lane;
      const int sv = i < P ? s[i] : 0;
      const int sp = i >= 1 && i <= P ? s[i - 1] : 0;
      const bool live = i >= 1 && i <= n;
      const bool sync = live && sv < 0;
      const uint32_t sb = __ballot_sync(kFull, sync);
      const uint32_t below = sb & ((1u << lane) - 1u);
      const int lastb = below ? base + 31 - __clz(below) : last;
      const bool prev_sync = lane ? ((sb >> (lane - 1)) & 1u) != 0 : sync_top;
      const bool head = i == 1 || prev_sync;
      const bool tail = sync || i == n;
      if (gid_row && i < P) gid_row[i] = cnt + __popc(below);
      if (live) {
        const float mb = clipf((float)sv, 1.0f, B);
        const float prev_mb = clipf((float)sp, 1.0f, B);
        const float mbe = sync ? (prev_sync ? 1.0f : prev_mb) : mb;
        const float stage = sync ? 1.0f : mb;
        const float Ai = tA[i] * scale, Ap = tA[i - 1] * scale;
        const float Wi = tW[i] * scale;
        const float bf = B * tF[i] / peak_macs;
        const int src = tSK[i];
        const bool has_skip = src >= 0;
        const bool same = has_skip && src > lastb;
        const float Asrc = tA[min(max(src, 0), P - 1)] * scale;
        const float cross_t = (has_skip && !same) ? 2.0f * B * Asrc : 0.0f;
        const float head_f = head ? 1.0f : 0.0f;
        const float tail_f = tail ? 1.0f : 0.0f;
        float vC, vT, vO, vM, vW;
        if (head && tail) {
          // streaming alternative: this layer alone in its group
          const float hold_a = same ? B * Asrc : 0.0f;
          vM = fminf(stage * Ai + (head_f * B) * Ap + hold_a, stream_buf);
          vC = bf / clipf(B * tOE[i] / lanes, kUtilMin, tUC[i]);
          vT = (head_f * B) * Ap + (tail_f * B) * Ai + Wi * 1.0f + cross_t;
          vO = B * (Ap + Ai) + Wi * 1.0f;
          vW = 1.0f;
        } else {
          const float waves = ceilf(B / mbe);
          const float hold = same ? mbe * Asrc : 0.0f;
          vM = stage * Ai + (head_f * mbe) * Ap + hold;
          vT = (head_f * B) * Ap + (tail_f * B) * Ai + Wi * waves + cross_t;
          vC = bf / clipf(mbe * tOE[i] / lanes, kUtilMin, tUC[i]);
          vO = B * (Ap + Ai) + Wi * waves;
          vW = waves;
        }
        x[i] = vC;
        x[TS + i] = vT;
        x[2 * TS + i] = vO;
        x[3 * TS + i] = vM;
        x[4 * TS + i] = vW;
      }
      const uint32_t tb = __ballot_sync(kFull, live && tail);
      if (lane == 0) tm[w] = tb;
      if (sb) last = base + 31 - __clz(sb);
      cnt += __popc(sb);
      sync_top = (sb >> 31) != 0;
    }
    __syncwarp();

    // -- 3. each group summed in position order by the lane at its head ----
    // (groups are independent, so they run side by side), with its roofline
    // time; the group's index is the count of tails before its head.
    int ng = 0;
    for (int base = 0, w = 0; base < P && base <= n; base += 32, ++w) {
      const int i = base + lane;
      const uint32_t tb = tm[w];
      const bool prev_tail = lane ? ((tb >> (lane - 1)) & 1u) != 0
                                  : (w > 0 && (tm[w - 1] >> 31) != 0);
      if (i >= 1 && i <= n && (i == 1 || prev_tail)) {
        int t = -1;         // the group's tail: the first tail at or past i
        for (int ww = w; t < 0; ++ww) {
          const uint32_t m = ww == w ? tb & ~((1u << lane) - 1u) : tm[ww];
          if (m) t = ww * 32 + __ffs(m) - 1;
        }
        float sC = 0.0f, sT = 0.0f, sO = 0.0f, sM = 0.0f, sW = 0.0f;
#pragma unroll 4
        for (int j = i; j <= t; ++j) {
          sC = sC + x[j];
          sT = sT + x[TS + j];
          sO = sO + x[2 * TS + j];
          sM = sM + x[3 * TS + j];
          sW = sW + x[4 * TS + j];
        }
        const bool single = t == i;
        const float gC = single ? x[i] : sC;
        const float gT = single ? x[TS + i] : sT;
        const float gO = single ? x[2 * TS + i] : sO;
        const float gW = single ? 1.0f : sW;
        const int g = ng + __popc(tb & ((1u << lane) - 1u));
        gv[g] = gC;
        gv[TS + g] = gT;
        gv[2 * TS + g] = gO;
        gv[3 * TS + g] = single ? x[3 * TS + i] : sM;
        gv[4 * TS + g] = gW;
        gv[5 * TS + g] = (float)(t - i + 1);
        lr[g] = maxp(maxp(gC, gT / bw_off), gO / bw_on)
                + (gW * t_pass + t_sync);
      }
      ng += __popc(tb);
    }
    if (lane == 0) ncols[r] = ng;
  }
  __syncthreads();

  // -- 4. CostOut: a thread a candidate sums its groups in order -----------
  if (tid < rows) {
    const int ng = ncols[tid];
    const float* lr = lg + tid * PS;
    const float* gT = gcol + TS + tid * PS;
    const float* gM = gcol + 3 * TS + tid * PS;
    float lat = 0.0f, traffic = 0.0f, peak = 0.0f;
    for (int g0 = 0; g0 < ng; g0 += kStep) {
      float xl[kStep], xt[kStep], xm[kStep];
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        xl[j] = lr[g0 + j];
        xt[j] = gT[g0 + j];
        xm[j] = gM[g0 + j];
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        if (g0 + j < ng) {
          lat = lat + xl[j];
          traffic = traffic + xt[j];
          peak = maxp(peak, xm[j]);
        }
      }
    }
    const size_t q = (size_t)c * a.POP + p0 + tid;
    a.lat[q] = lat;
    a.peak[q] = peak;
    a.traf[q] = traffic;
    a.valid[q] = peak <= a.budget[c] ? 1 : 0;
    a.ngroups[q] = ng;
  }

  // -- 5. the group matrices the form asks for, as whole rows --------------
  const size_t out0 = ((size_t)c * a.POP + p0) * P;
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
    float* out = a.mats[m];
    if (out == nullptr) continue;
    for (int e = tid; e < rows * P; e += kThreads) {
      const int r = e / P, g = e - r * P;
      out[out0 + e] = g < ncols[r] ? gcol[m * TS + r * PS + g] : 0.0f;
    }
  }
}

__global__ void probe_kernel(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" {

// One packed int64 argument: 24 pointers in Args order (strat, A, W, F, OE,
// UC, SKIP, n, batch, BPE, hw, budget, latency, peak, traffic, valid,
// n_groups, gid, C_g, T_g, O_g, M_g, wave_g, glen; 0 = not written), then C,
// POP, P, tile, stream.  Launches on `stream`; returns cudaGetLastError().
int fusion_eval_launch(const int64_t* p) {
  Args a;
  a.strat = (const int32_t*)p[0];
  a.A = (const float*)p[1];
  a.W = (const float*)p[2];
  a.F = (const float*)p[3];
  a.OE = (const float*)p[4];
  a.UC = (const float*)p[5];
  a.skip = (const int32_t*)p[6];
  a.n = (const int32_t*)p[7];
  a.batch = (const float*)p[8];
  a.bpe = (const float*)p[9];
  a.hw = (const float*)p[10];
  a.budget = (const float*)p[11];
  a.lat = (float*)p[12];
  a.peak = (float*)p[13];
  a.traf = (float*)p[14];
  a.valid = (uint8_t*)p[15];
  a.ngroups = (int32_t*)p[16];
  a.gid = (int32_t*)p[17];
  for (int m = 0; m < kMats; ++m) a.mats[m] = (float*)p[18 + m];
  const int C = (int)p[24];
  a.POP = (int)p[25];
  a.P = (int)p[26];
  a.tile = (int)p[27];
  cudaStream_t stream = (cudaStream_t)p[28];
  const size_t shmem = smem_bytes(a.P, a.tile);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fusion_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.POP + a.tile - 1) / a.tile, C);
  fusion_eval_kernel<<<grid, kThreads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

int fusion_eval_probe(void* x, int n, void* stream) {
  probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>((float*)x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
