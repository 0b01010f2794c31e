// Fair-share grid-tick kernels, for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernels in
// src/repro/kernels/grid_tick.py:
//   - bank_fused_kernel  <- grid_tick_bank_fused_pallas / _bank_fused_kernel
//     (K fair-share ticks per launch, the carry resident on chip);
//   - bank_tick_kernel   <- grid_tick_bank_pallas / _bank_tick_kernel
//     (one tick -> xfer, proc_xfer, link_xfer; the leap engine's rates);
//   - campaign_tick_kernel <- grid_tick_pallas / _tick_kernel
//     (one tick of B simulations of one campaign; see its own note below).
//
// What bounds them on the card. Per element and tick the work is a few
// hundred scalar operations on ~T legs, P processes and L links (T <= 128,
// P <= 128, L <= 32), so neither kernel comes near the tensor cores or the
// fp32 peak. The one-tick kernel moves its inputs and outputs once, and is
// bound by memory bytes. The fused kernel reads and writes the carry once per
// window and reads one noise row per tick, so at K ticks per launch its bytes
// per tick shrink K-fold and what remains is latency: each tick is a chain of
// dependent segment sums inside one warp.
//
// What the design does about it. One warp owns one (scenario, replica)
// element. Its legs are strided over the lanes (lane i holds legs i, i + 32,
// ...), its links sit one per lane, and the whole carry stays in registers for
// the K loop. The one-hot contractions of the TPU kernel become index
// gathers (bitwise equal: a one-hot dot sums one term and zeros). Each block
// holds the warps of one scenario and stages that scenario's index tables in
// shared memory once; per-warp scratch rows carry the per-tick exchanges
// (active flags, per-process and per-link sums). The segment sums run in
// ascending leg order with no float atomics, so the result is bitwise the
// same run to run and for every window size K. A warp leaves its loop as
// soon as its element is finished or clocked out, which is exact: a dead
// element never changes again.
//
// Rounding follows the plain PyTorch version (repro_torch/kernels/ref.py):
// every float operation is written as an explicit round-to-nearest intrinsic
// and the library is built with --fmad=false; the one fused multiply-add,
// mu + sigma * noise, is __fmaf_rn, as the plain version's fma().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;
constexpr int kMaxP = 128;
constexpr int kMaxL = 32;
constexpr int kLegsPerLane = kMaxT / kWarp;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct FusedArgs {
  // carry in
  const int* t;
  const int* steps;
  const float* remaining;
  const unsigned char* done;
  const unsigned char* started;
  const int* t_start;
  const int* t_end;
  const float* conth;
  const float* conpr;
  const float* bg;
  // window noise and campaign constants
  const float* noise;      // [K, S, R, L]
  const float* mu;         // [S, R or 1, L]
  const float* sigma;      // [S, R or 1, L]
  int bg_rstride;          // L for per-replica moments, else 0
  const int* release;      // [S, T]
  const int* dep;          // [S, T], -1 = none
  const int* period;       // [S, L]
  const int* max_ticks;    // [S]
  const float* keep;       // [S, R or 1, T]
  int keep_rstride;        // T for per-replica keeps, else 0
  const float* bw;         // [S, L]
  const int* proc_of_leg;  // [S, T]
  const int* link_of_leg;  // [S, T]
  const int* link_of_proc; // [S, P]
  // carry out
  int* t_out;
  int* steps_out;
  float* remaining_out;
  unsigned char* done_out;
  unsigned char* started_out;
  int* t_start_out;
  int* t_end_out;
  float* conth_out;
  float* conpr_out;
  float* bg_out;
  int S, R, T, P, L, K;
};

struct TickArgs {
  const float* active;     // [S, R, T]
  const float* remaining;  // [S, R, T]
  const float* keep;       // [S, R or 1, T]
  int keep_rstride;
  const float* bg;         // [S, R, L]
  const float* bw;         // [S, L]
  const int* proc_of_leg;
  const int* link_of_leg;
  const int* link_of_proc;
  float* xfer;             // [S, R, T]
  float* proc_xfer;        // [S, R, P]
  float* link_xfer;        // [S, R, L]
  int S, R, T, P, L;
};

// Per-scenario index tables, staged once per block.
struct ScenarioTables {
  int proc_of_leg[kMaxT];
  int link_of_leg[kMaxT];
  int link_of_proc[kMaxP];
};

// Per-warp exchange rows for one tick.
struct WarpScratch {
  float a[kMaxT];        // active flags (0/1)
  float x[kMaxT];        // xfer per leg
  unsigned char done[kMaxT];
  float threads[kMaxP];  // active legs per process
  float px[kMaxP];       // xfer per process
  float ppbw[kMaxL];     // per-process bandwidth per link
  float lx[kMaxL];       // xfer per link
};

__device__ void stage_tables(ScenarioTables& tb, const int* proc_of_leg,
                             const int* link_of_leg, const int* link_of_proc,
                             int s, int T, int P) {
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    tb.proc_of_leg[i] = proc_of_leg[(size_t)s * T + i];
    tb.link_of_leg[i] = link_of_leg[(size_t)s * T + i];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    tb.link_of_proc[i] = link_of_proc[(size_t)s * P + i];
  }
}

// The fair share of one tick for one element, from ws.a (set by the caller)
// to ws.x / ws.px / ws.lx. av, keep, rem hold the lane's legs; bgv and bwv
// the lane's link. Returns the lane's xfer values in xf.
__device__ void fair_share(const ScenarioTables& tb, WarpScratch& ws,
                           const float (&av)[kLegsPerLane],
                           const float (&keep)[kLegsPerLane],
                           const float (&rem)[kLegsPerLane],
                           float (&xf)[kLegsPerLane], float bgv, float bwv,
                           int lane, int T, int P, int L) {
  // threads per process: ascending sum of the 0/1 flags
  for (int p = lane; p < P; p += kWarp) {
    float c = 0.f;
    for (int i = 0; i < T; ++i) {
      if (tb.proc_of_leg[i] == p) c = __fadd_rn(c, ws.a[i]);
    }
    ws.threads[p] = c;
  }
  __syncwarp();
  // campaign processes per link, fair share per process
  if (lane < L) {
    float c = 0.f;
    for (int p = 0; p < P; ++p) {
      if (tb.link_of_proc[p] == lane && ws.threads[p] > 0.f) c = __fadd_rn(c, 1.f);
    }
    float denom = fmaxf(__fadd_rn(c, fmaxf(bgv, 0.f)), 1.f);
    ws.ppbw[lane] = __fdiv_rn(bwv, denom);
  }
  __syncwarp();
  #pragma unroll
  for (int j = 0; j < kLegsPerLane; ++j) {
    int i = lane + j * kWarp;
    if (i < T) {
      float threads_leg = fmaxf(ws.threads[tb.proc_of_leg[i]], 1.f);
      float chunk = __fdiv_rn(
          __fmul_rn(__fmul_rn(av[j], keep[j]), ws.ppbw[tb.link_of_leg[i]]),
          threads_leg);
      xf[j] = fminf(rem[j], chunk);
      ws.x[i] = xf[j];
    }
  }
  __syncwarp();
  // per-process and per-link sums of xfer, ascending leg order
  for (int p = lane; p < P; p += kWarp) {
    float acc = 0.f;
    for (int i = 0; i < T; ++i) {
      if (tb.proc_of_leg[i] == p) acc = __fadd_rn(acc, ws.x[i]);
    }
    ws.px[p] = acc;
  }
  if (lane < L) {
    float acc = 0.f;
    for (int i = 0; i < T; ++i) {
      if (tb.link_of_leg[i] == lane) acc = __fadd_rn(acc, ws.x[i]);
    }
    ws.lx[lane] = acc;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
bank_fused_kernel(FusedArgs g) {
  __shared__ ScenarioTables tb;
  __shared__ WarpScratch scratch[kWarpsPerBlock];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kWarpsPerBlock + warp;
  const int T = g.T, P = g.P, L = g.L;
  stage_tables(tb, g.proc_of_leg, g.link_of_leg, g.link_of_proc, s, T, P);
  __syncthreads();
  if (r >= g.R) return;  // warp-uniform; no block barrier follows
  WarpScratch& ws = scratch[warp];

  const size_t e = (size_t)s * g.R + r;
  const size_t leg0 = e * T;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  float rem[kLegsPerLane], cth[kLegsPerLane], cpr[kLegsPerLane], keep[kLegsPerLane];
  int tst[kLegsPerLane], ten[kLegsPerLane], rel[kLegsPerLane], dp[kLegsPerLane];
  bool dn[kLegsPerLane], st[kLegsPerLane];
  #pragma unroll
  for (int j = 0; j < kLegsPerLane; ++j) {
    int i = lane + j * kWarp;
    if (i < T) {
      rem[j] = g.remaining[leg0 + i];
      cth[j] = g.conth[leg0 + i];
      cpr[j] = g.conpr[leg0 + i];
      keep[j] = keep_row[i];
      tst[j] = g.t_start[leg0 + i];
      ten[j] = g.t_end[leg0 + i];
      dn[j] = g.done[leg0 + i] != 0;
      st[j] = g.started[leg0 + i] != 0;
      rel[j] = g.release[(size_t)s * T + i];
      dp[j] = g.dep[(size_t)s * T + i];
    } else {  // lane slots past the last leg are inert and born done
      rem[j] = cth[j] = cpr[j] = keep[j] = 0.f;
      tst[j] = ten[j] = rel[j] = 0;
      dp[j] = -1;
      dn[j] = true;
      st[j] = false;
    }
  }
  const size_t link0 = e * L;
  const size_t bg_off = (size_t)s * (g.bg_rstride ? (size_t)g.R * L : L)
                        + (size_t)r * g.bg_rstride;
  float bgv = 0.f, mu = 0.f, sigma = 0.f, bwv = 0.f;
  int per = 1;
  if (lane < L) {
    bgv = g.bg[link0 + lane];
    mu = g.mu[bg_off + lane];
    sigma = g.sigma[bg_off + lane];
    bwv = g.bw[(size_t)s * L + lane];
    per = g.period[(size_t)s * L + lane];
  }
  int tc = g.t[e];
  int steps = g.steps[e];
  const int mt = g.max_ticks[s];
  const size_t noise_stride = (size_t)g.S * g.R * L;

  for (int k = 0; k < g.K; ++k) {
    bool mine_done = true;
    #pragma unroll
    for (int j = 0; j < kLegsPerLane; ++j) mine_done = mine_done && dn[j];
    const bool all_done = __all_sync(kFull, mine_done);
    if (tc >= mt || all_done) break;  // dead elements never change again

    if (lane < L) {
      float z = g.noise[(size_t)k * noise_stride + link0 + lane];
      float fresh = fmaxf(__fmaf_rn(sigma, z, mu), 0.f);
      if (tc % per == 0) bgv = fresh;
    }
    #pragma unroll
    for (int j = 0; j < kLegsPerLane; ++j) {
      int i = lane + j * kWarp;
      if (i < T) ws.done[i] = dn[j];
    }
    __syncwarp();
    float av[kLegsPerLane], xf[kLegsPerLane];
    #pragma unroll
    for (int j = 0; j < kLegsPerLane; ++j) {
      int i = lane + j * kWarp;
      bool act = false;
      if (i < T) {
        bool dep_ok = dp[j] < 0 || ws.done[dp[j]] != 0;
        act = !dn[j] && rel[j] <= tc && dep_ok;
        ws.a[i] = act ? 1.f : 0.f;
      }
      av[j] = act ? 1.f : 0.f;
      xf[j] = 0.f;
    }
    __syncwarp();
    fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, lane, T, P, L);
    #pragma unroll
    for (int j = 0; j < kLegsPerLane; ++j) {
      int i = lane + j * kWarp;
      if (i < T) {
        float own_proc = ws.px[tb.proc_of_leg[i]];
        float own_link = ws.lx[tb.link_of_leg[i]];
        cth[j] = __fadd_rn(cth[j], __fmul_rn(av[j], __fsub_rn(own_proc, xf[j])));
        cpr[j] = __fadd_rn(cpr[j], __fmul_rn(av[j], __fsub_rn(own_link, own_proc)));
        rem[j] = __fsub_rn(rem[j], xf[j]);
        bool act = av[j] > 0.f;
        if (act && !st[j]) tst[j] = tc;
        st[j] = st[j] || act;
        if (act && rem[j] <= 1e-6f) {
          dn[j] = true;
          ten[j] = tc + 1;
        }
      }
    }
    tc += 1;
    steps += 1;
    __syncwarp();  // the next tick rewrites the scratch rows
  }

  if (lane == 0) {
    g.t_out[e] = tc;
    g.steps_out[e] = steps;
  }
  #pragma unroll
  for (int j = 0; j < kLegsPerLane; ++j) {
    int i = lane + j * kWarp;
    if (i < T) {
      g.remaining_out[leg0 + i] = rem[j];
      g.done_out[leg0 + i] = dn[j] ? 1 : 0;
      g.started_out[leg0 + i] = st[j] ? 1 : 0;
      g.t_start_out[leg0 + i] = tst[j];
      g.t_end_out[leg0 + i] = ten[j];
      g.conth_out[leg0 + i] = cth[j];
      g.conpr_out[leg0 + i] = cpr[j];
    }
  }
  if (lane < L) g.bg_out[link0 + lane] = bgv;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
bank_tick_kernel(TickArgs g) {
  __shared__ ScenarioTables tb;
  __shared__ WarpScratch scratch[kWarpsPerBlock];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kWarpsPerBlock + warp;
  const int T = g.T, P = g.P, L = g.L;
  stage_tables(tb, g.proc_of_leg, g.link_of_leg, g.link_of_proc, s, T, P);
  __syncthreads();
  if (r >= g.R) return;
  WarpScratch& ws = scratch[warp];

  const size_t e = (size_t)s * g.R + r;
  const size_t leg0 = e * T;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  float av[kLegsPerLane], keep[kLegsPerLane], rem[kLegsPerLane], xf[kLegsPerLane];
  #pragma unroll
  for (int j = 0; j < kLegsPerLane; ++j) {
    int i = lane + j * kWarp;
    av[j] = keep[j] = rem[j] = xf[j] = 0.f;
    if (i < T) {
      av[j] = g.active[leg0 + i];
      keep[j] = keep_row[i];
      rem[j] = g.remaining[leg0 + i];
      ws.a[i] = av[j];
    }
  }
  float bgv = 0.f, bwv = 0.f;
  if (lane < L) {
    bgv = g.bg[e * L + lane];
    bwv = g.bw[(size_t)s * L + lane];
  }
  __syncwarp();
  fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, lane, T, P, L);
  #pragma unroll
  for (int j = 0; j < kLegsPerLane; ++j) {
    int i = lane + j * kWarp;
    if (i < T) g.xfer[leg0 + i] = xf[j];
  }
  for (int p = lane; p < P; p += kWarp) g.proc_xfer[e * P + p] = ws.px[p];
  if (lane < L) g.link_xfer[e * L + lane] = ws.lx[lane];
}


// ---------------------------------------------------------------------------
// campaign_tick_kernel: one fair-share tick of B simulations of one campaign
// ---------------------------------------------------------------------------
//
// Replaces grid_tick_pallas (src/repro/kernels/grid_tick.py:115), whose
// _tick_kernel broadcasts the campaign's dense one-hot incidences into VMEM
// and contracts them on the MXU. Here the incidences arrive as index tables
// (repro_torch.kernels.ref.campaign_index_tables, packed into one int32
// buffer): the gathers read one column per leg, and every segment sum walks
// an ascending CSR list of legs (or processes), so a one-hot dot's "one term
// and zeros" becomes that term, bitwise, and the float sums are the plain
// grid_tick_indexed's, in the same order, with no float atomics.
//
// What bounds it: one launch reads active, remaining and keep and writes
// xfer ([B, T] each), a few hundred bytes of tables and [B, P + L] sums; a
// few operations per byte, so memory, and at the engine's shapes (B up to a
// few thousand, T ~ 100) the launch latency comes first.
//
// Layout: one warp per simulation row, kWarpsPerBlock rows per block (fewer
// when the tables and scratch rows would pass 48 KB). The campaign's tables
// are staged in shared memory once per block; each warp keeps its row's
// active flags, transfers and per-process and per-link values in its own
// scratch rows. Legs are strided over the lanes, processes and links too.
// Limits: T <= kMaxCampaignT legs, P <= T processes, L <= kMaxCampaignL links.

constexpr int kMaxCampaignT = 1024;
constexpr int kMaxCampaignL = 256;

struct CampaignArgs {
  const float* active;     // [B, T]
  const float* remaining;  // [B, T]
  const float* keep;       // [T] or [B, T]
  int keep_rstride;        // T for per-row keeps, else 0
  const float* bg;         // [B, L]
  const float* bw;         // [L]
  const int* tables;       // packed, see ref.CampaignTables
  int n_tables;
  float* xfer;             // [B, T]
  float* proc_xfer;        // [B, P]
  float* link_xfer;        // [B, L]
  int B, T, P, L, rows_per_block;
};

// Scratch floats per warp: active flags and transfers per leg, threads and
// transfers per process, fair share and transfers per link.
__host__ __device__ inline int campaign_scratch_floats(int T, int P, int L) {
  return 2 * T + 2 * P + 2 * L;
}

// Segment sum of v over the ascending list idx[ptr[c] .. ptr[c + 1]).
__device__ inline float ascending_sum(const float* v, const int* ptr,
                                      const int* idx, int c) {
  float acc = 0.f;
  for (int j = ptr[c]; j < ptr[c + 1]; ++j) acc = __fadd_rn(acc, v[idx[j]]);
  return acc;
}

__global__ void campaign_tick_kernel(CampaignArgs g) {
  extern __shared__ int smem[];
  const int T = g.T, P = g.P, L = g.L;
  for (int i = threadIdx.x; i < g.n_tables; i += blockDim.x) smem[i] = g.tables[i];
  __syncthreads();
  const int* proc_of_leg = smem;
  const int* link_of_leg = proc_of_leg + T;
  const int* proc_ptr = link_of_leg + T;
  const int* proc_legs = proc_ptr + P + 1;
  const int* link_ptr = proc_legs + proc_ptr[P];
  const int* link_legs = link_ptr + L + 1;
  const int* link_proc_ptr = link_legs + link_ptr[L];
  const int* link_procs = link_proc_ptr + L + 1;

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * g.rows_per_block + warp;
  if (row >= g.B) return;  // warp-uniform; no block barrier follows
  float* ws = reinterpret_cast<float*>(smem + g.n_tables) +
              (size_t)warp * campaign_scratch_floats(T, P, L);
  float* act = ws;
  float* xs = act + T;
  float* threads = xs + T;
  float* px = threads + P;
  float* ppbw = px + P;
  float* lx = ppbw + L;

  const size_t leg0 = (size_t)row * T;
  const float* keep_row = g.keep + (size_t)row * g.keep_rstride;
  for (int i = lane; i < T; i += kWarp) act[i] = g.active[leg0 + i];
  __syncwarp();
  // threads per process: ascending sums of the active flags
  for (int p = lane; p < P; p += kWarp) {
    threads[p] = ascending_sum(act, proc_ptr, proc_legs, p);
  }
  __syncwarp();
  // active campaign processes per link, fair share per process
  for (int l = lane; l < L; l += kWarp) {
    float c = 0.f;
    for (int j = link_proc_ptr[l]; j < link_proc_ptr[l + 1]; ++j) {
      if (threads[link_procs[j]] > 0.f) c = __fadd_rn(c, 1.f);
    }
    const float denom = fmaxf(__fadd_rn(c, fmaxf(g.bg[(size_t)row * L + l], 0.f)), 1.f);
    ppbw[l] = __fdiv_rn(g.bw[l], denom);
  }
  __syncwarp();
  for (int i = lane; i < T; i += kWarp) {
    const float threads_leg = fmaxf(threads[proc_of_leg[i]], 1.f);
    const float chunk = __fdiv_rn(
        __fmul_rn(__fmul_rn(act[i], keep_row[i]), ppbw[link_of_leg[i]]), threads_leg);
    const float x = fminf(g.remaining[leg0 + i], chunk);
    xs[i] = x;
    g.xfer[leg0 + i] = x;
  }
  __syncwarp();
  for (int p = lane; p < P; p += kWarp) {
    g.proc_xfer[(size_t)row * P + p] = ascending_sum(xs, proc_ptr, proc_legs, p);
  }
  for (int l = lane; l < L; l += kWarp) {
    g.link_xfer[(size_t)row * L + l] = ascending_sum(xs, link_ptr, link_legs, l);
  }
}

}  // namespace

extern "C" {

// Limits of the static shared-memory layout; the wrappers check against them.
int grid_tick_limits(int* max_t, int* max_p, int* max_l) {
  *max_t = kMaxT;
  *max_p = kMaxP;
  *max_l = kMaxL;
  return 0;
}

int grid_tick_bank_fused_launch(
    const int* t, const int* steps, const float* remaining,
    const unsigned char* done, const unsigned char* started,
    const int* t_start, const int* t_end, const float* conth,
    const float* conpr, const float* bg, const float* noise, const float* mu,
    const float* sigma, int bg_rstride, const int* release, const int* dep,
    const int* period, const int* max_ticks, const float* keep,
    int keep_rstride, const float* bw, const int* proc_of_leg,
    const int* link_of_leg, const int* link_of_proc, int* t_out,
    int* steps_out, float* remaining_out, unsigned char* done_out,
    unsigned char* started_out, int* t_start_out, int* t_end_out,
    float* conth_out, float* conpr_out, float* bg_out, int S, int R, int T,
    int P, int L, int K, void* stream) {
  if (T > kMaxT || P > kMaxP || L > kMaxL || S < 1 || R < 1 || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FusedArgs g{t, steps, remaining, done, started, t_start, t_end, conth,
              conpr, bg, noise, mu, sigma, bg_rstride, release, dep, period,
              max_ticks, keep, keep_rstride, bw, proc_of_leg, link_of_leg,
              link_of_proc, t_out, steps_out, remaining_out, done_out,
              started_out, t_start_out, t_end_out, conth_out, conpr_out,
              bg_out, S, R, T, P, L, K};
  dim3 grid(S, (R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bank_fused_kernel<<<grid, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

int grid_tick_bank_launch(
    const float* active, const float* remaining, const float* keep,
    int keep_rstride, const float* bg, const float* bw,
    const int* proc_of_leg, const int* link_of_leg, const int* link_of_proc,
    float* xfer, float* proc_xfer, float* link_xfer, int S, int R, int T,
    int P, int L, void* stream) {
  if (T > kMaxT || P > kMaxP || L > kMaxL || S < 1 || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  TickArgs g{active, remaining, keep, keep_rstride, bg, bw, proc_of_leg,
             link_of_leg, link_of_proc, xfer, proc_xfer, link_xfer,
             S, R, T, P, L};
  dim3 grid(S, (R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bank_tick_kernel<<<grid, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}


// Limits of the per-campaign kernel; the wrapper checks against them.
int grid_tick_campaign_limits(int* max_t, int* max_p, int* max_l) {
  *max_t = kMaxCampaignT;
  *max_p = kMaxCampaignT;
  *max_l = kMaxCampaignL;
  return 0;
}

int grid_tick_campaign_launch(
    const float* active, const float* remaining, const float* keep,
    int keep_rstride, const float* bg, const float* bw, const int* tables,
    int n_tables, float* xfer, float* proc_xfer, float* link_xfer, int B,
    int T, int P, int L, void* stream) {
  if (T < 1 || T > kMaxCampaignT || P < 1 || P > T || L < 1 ||
      L > kMaxCampaignL || B < 1 || n_tables > 4 * T + 2 * P + 2 * L + 3) {
    return (int)cudaErrorInvalidValue;
  }
  // as many warps (rows) per block as fit beside the tables in 48 KB
  const size_t table_bytes = (size_t)n_tables * sizeof(int);
  const size_t row_bytes = (size_t)campaign_scratch_floats(T, P, L) * sizeof(float);
  int rows = kWarpsPerBlock;
  while (rows > 1 && table_bytes + rows * row_bytes > 48 * 1024) --rows;
  const size_t smem = table_bytes + rows * row_bytes;
  CampaignArgs g{active, remaining, keep, keep_rstride, bg, bw, tables,
                 n_tables, xfer, proc_xfer, link_xfer, B, T, P, L, rows};
  dim3 grid((B + rows - 1) / rows);
  campaign_tick_kernel<<<grid, rows * kWarp, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
