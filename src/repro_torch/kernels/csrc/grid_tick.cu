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
// and one that has no Pallas counterpart:
//   - bank_sums_kernel: the leap step's per-process and per-link sums of the
//     event step's last tick (the reference takes them as one-hot dots,
//     src/repro/kernels/ref.py:307), in the order of the other two.
//
// What bounds them on the card. Per element and tick the work is a few
// hundred scalar operations on ~T legs, P processes and L links (T <= 128,
// P <= 128, L <= 32), so neither kernel comes near the tensor cores or the
// fp32 peak, and the one-tick kernel moves its inputs and outputs once. What
// bounds both in practice is the warp's instruction stream: each tick is a
// chain of dependent segment sums inside one warp, so the cost is issue
// slots and the latency between them, which more resident warps hide.
//
// Layout. One warp owns one (scenario, replica) element, and the whole carry
// stays in registers for the K loop. Each block holds the warps of one
// scenario and stages that scenario's tables in shared memory once
// (ref.BankTables.packed: the process and link of each leg, the legs of each
// process and the processes of each link as ascending lists), and builds from
// the lists one bit mask per process over the legs and one per link over the
// processes. A warp leaves its loop as soon as its element is finished or
// clocked out, which is exact: a dead element never changes again. Each warp
// issues its element's loads before the block stages the tables, and the
// fused kernel loads the next tick's normals while a tick runs.
//
// How the lanes split one tick (lane k):
//   - legs: lane k holds legs k, k + 32, ... in ceil(T / 32) slots (the
//     kernels are built for 1 to 4 slots, so the carry takes the registers
//     of the legs there are): the per-leg share, the accumulators, the carry;
//   - active legs per process and active processes per link are integers, so
//     they need no order: a ballot of the active flags a slot, then a popcount
//     under each process's leg mask (lane k counts processes k, k + 32, ...)
//     and, from a ballot of the active processes, under each link's process
//     mask (lane k counts link k). No lane walks a list for a count, so a
//     link with 80 processes costs what a link with one does;
//   - xfer per process: lane k walks the legs of processes k, k + 32, ...;
//   - xfer per link: lane k walks the processes of link k and adds their
//     sums. A link's sum walks its processes, not its legs: on an L = 1
//     scenario no lane walks all T legs while the others wait; the longest
//     walk is the largest process or the busiest link.
// The float sums run one term at a time from 0.0 with __fadd_rn, in list
// order, with no float atomics: bitwise what ref.grid_tick_bank_indexed
// computes, run to run and for every window size K. A link that carries one
// process sums to exactly that process's sum, so its ConPr adds exact zeros.
// At the main bank (S 1,024, padded T 93, P 80, L 11; a scenario has on
// average 17 legs, 12 processes and 2.5 links, the longest process list ~4
// legs and the busiest link ~7 processes) a tick should cost ~300-400 warp
// instructions an element; a compare-scan of every segment over the padded
// T, P and L would cost ~5,000.
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
constexpr int kMaxSlots = kMaxT / kWarp;  // leg slots a lane
constexpr int kProcWords = kMaxP / kWarp;
constexpr int kWarpsPerBlock = 4;
// Warps (elements) per block of the bank kernels: the scenario's tables are
// staged once per block. ~5 KB of tables and ~1.8 KB of scratch a warp.
constexpr int kBankWarps = 4;
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
  const int* tables;       // [S, bank_table_words(T, P, L)]
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

struct SumsArgs {
  const float* v;          // [S, R, T]
  const int* tables;       // [S, bank_table_words(T, P, L)]
  float* proc;             // [S, R, P]
  float* link;             // [S, R, L]
  int S, R, T, P, L;
};

struct TickArgs {
  const float* active;     // [S, R, T]
  const float* remaining;  // [S, R, T]
  const float* keep;       // [S, R or 1, T]
  int keep_rstride;
  const float* bg;         // [S, R, L]
  const float* bw;         // [S, L]
  const int* tables;       // [S, bank_table_words(T, P, L)]
  float* xfer;             // [S, R, T]
  float* proc_xfer;        // [S, R, P]
  float* link_xfer;        // [S, R, L]
  int S, R, T, P, L;
};

// Words of one scenario's packed tables: proc_of_leg[T] | link_of_leg[T] |
// proc_ptr[P + 1] | proc_legs[T] | link_proc_ptr[L + 1] | link_procs[P].
__host__ __device__ inline int bank_table_words(int T, int P, int L) {
  return 3 * T + 2 * P + L + 2;
}

// One scenario's tables, staged once per block.
struct ScenarioTables {
  int proc_of_leg[kMaxT];
  int link_of_leg[kMaxT];
  int proc_ptr[kMaxP + 1];
  int proc_legs[kMaxT];
  int link_proc_ptr[kMaxL + 1];
  int link_procs[kMaxP];
  unsigned leg_mask[kMaxP][kMaxSlots];  // bit k of word j: leg 32 j + k is the process's
  unsigned proc_mask[kMaxL][kProcWords];   // bit k of word w: process 32 w + k is the link's
  int n_proc;  // 1 + the last process in any list (at least 1)
};

// Per-warp exchange rows for one tick.
struct WarpScratch {
  float x[kMaxT];        // xfer per leg
  int threads[kMaxP];    // active legs per process
  float px[kMaxP];       // xfer per process
  float ppbw[kMaxL];     // per-process bandwidth per link
  float lx[kMaxL];       // xfer per link
};

__device__ void stage_tables(ScenarioTables& tb, const int* tables, int s, int T, int P, int L) {
  const int* src = tables + (size_t)s * bank_table_words(T, P, L);
  const int* proc_ptr = src + 2 * T;
  const int* proc_legs = proc_ptr + P + 1;
  const int* link_proc_ptr = proc_legs + T;
  const int* link_procs = link_proc_ptr + L + 1;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    tb.proc_of_leg[i] = src[i];
    tb.link_of_leg[i] = src[T + i];
    tb.proc_legs[i] = proc_legs[i];
  }
  for (int i = threadIdx.x; i <= P; i += blockDim.x) tb.proc_ptr[i] = proc_ptr[i];
  for (int i = threadIdx.x; i < P; i += blockDim.x) tb.link_procs[i] = link_procs[i];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) tb.link_proc_ptr[i] = link_proc_ptr[i];
  for (int i = threadIdx.x; i < P * kMaxSlots; i += blockDim.x) (&tb.leg_mask[0][0])[i] = 0u;
  for (int i = threadIdx.x; i < L * kProcWords; i += blockDim.x) (&tb.proc_mask[0][0])[i] = 0u;
  if (threadIdx.x == 0) tb.n_proc = 1;
  __syncthreads();
  // the masks from the lists, one process (link) per thread
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int a = tb.proc_ptr[p], b = tb.proc_ptr[p + 1];
    for (int k = a; k < b; ++k) {
      const int leg = tb.proc_legs[k];
      tb.leg_mask[p][leg / kWarp] |= 1u << (leg % kWarp);
    }
    if (b > a) atomicMax(&tb.n_proc, p + 1);
  }
  // a link may list a process that has no leg: its sum is 0, so it counts
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    for (int k = tb.link_proc_ptr[l]; k < tb.link_proc_ptr[l + 1]; ++k) {
      const int p = tb.link_procs[k];
      tb.proc_mask[l][p / kWarp] |= 1u << (p % kWarp);
      atomicMax(&tb.n_proc, p + 1);
    }
  }
  __syncthreads();
}

// Bit i of the per-slot ballots b (bit k of b[j] is leg 32 j + k).
template <int kSlots>
__device__ inline bool ballot_bit(const unsigned (&b)[kSlots], int i) {
  const int w = i / kWarp;
  unsigned word = b[0];
  #pragma unroll
  for (int j = 1; j < kSlots; ++j) word = w == j ? b[j] : word;
  return (word >> (i % kWarp)) & 1u;
}

// The float segment sums of one element's per-leg values ws.x, in list
// order from 0.0: ws.px[p] over the legs of process p (p < n_proc), ws.lx[l]
// over the sums of the processes of link l.
__device__ void segment_sums(const ScenarioTables& tb, WarpScratch& ws, int lane, int L) {
  for (int p = lane; p < tb.n_proc; p += kWarp) {
    float acc = 0.f;
    for (int k = tb.proc_ptr[p]; k < tb.proc_ptr[p + 1]; ++k) {
      acc = __fadd_rn(acc, ws.x[tb.proc_legs[k]]);
    }
    ws.px[p] = acc;
  }
  __syncwarp();
  if (lane < L) {
    float acc = 0.f;
    for (int k = tb.link_proc_ptr[lane]; k < tb.link_proc_ptr[lane + 1]; ++k) {
      acc = __fadd_rn(acc, ws.px[tb.link_procs[k]]);
    }
    ws.lx[lane] = acc;
  }
  __syncwarp();
}

// The fair share of one tick for one element, from the lane's active flags
// av to its transfers xf and the warp's ws.px and ws.lx. av, keep, rem hold
// the lane's legs; bgv and bwv the lane's link.
template <int kSlots>
__device__ void fair_share(const ScenarioTables& tb, WarpScratch& ws,
                           const float (&av)[kSlots], const float (&keep)[kSlots],
                           const float (&rem)[kSlots], float (&xf)[kSlots],
                           float bgv, float bwv, int lane, int T, int L) {
  unsigned act[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) act[j] = __ballot_sync(kFull, av[j] > 0.f);
  const int np = tb.n_proc;
  // active legs per process (popcounts under its leg mask), and a ballot of
  // the active processes per word of 32
  unsigned pact[kProcWords];
  #pragma unroll
  for (int w = 0; w < kProcWords; ++w) {
    pact[w] = 0u;
    if (w * kWarp < np) {  // warp-uniform
      const int p = w * kWarp + lane;
      int c = 0;
      if (p < np) {
        #pragma unroll
        for (int j = 0; j < kSlots; ++j) c += __popc(act[j] & tb.leg_mask[p][j]);
        ws.threads[p] = c;
      }
      pact[w] = __ballot_sync(kFull, c > 0);
    }
  }
  // active campaign processes per link, fair share per process
  if (lane < L) {
    int c = 0;
    #pragma unroll
    for (int w = 0; w < kProcWords; ++w) c += __popc(pact[w] & tb.proc_mask[lane][w]);
    const float denom = fmaxf(__fadd_rn(__int2float_rn(c), fmaxf(bgv, 0.f)), 1.f);
    ws.ppbw[lane] = __fdiv_rn(bwv, denom);
  }
  __syncwarp();
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = lane + j * kWarp;
    if (i < T) {
      const float threads_leg = fmaxf(__int2float_rn(ws.threads[tb.proc_of_leg[i]]), 1.f);
      const float chunk = __fdiv_rn(
          __fmul_rn(__fmul_rn(av[j], keep[j]), ws.ppbw[tb.link_of_leg[i]]), threads_leg);
      xf[j] = fminf(rem[j], chunk);
      ws.x[i] = xf[j];
    }
  }
  __syncwarp();
  segment_sums(tb, ws, lane, L);
}

// kSlots = ceil(T / 32) leg slots a lane, so the carry takes the registers
// of the legs there are. Each warp loads its element's carry before the
// block stages the tables, so the two latencies overlap.
template <int kSlots>
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_fused_kernel(FusedArgs g) {
  __shared__ ScenarioTables tb;
  __shared__ WarpScratch scratch[kBankWarps];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, L = g.L;

  const size_t e = (size_t)s * g.R + r;
  const size_t leg0 = e * T;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  float rem[kSlots], cth[kSlots], cpr[kSlots], keep[kSlots];
  int tst[kSlots], ten[kSlots], rel[kSlots], dp[kSlots];
  bool dn[kSlots], st[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    if (live && i < T) {
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
  const size_t noise_stride = (size_t)g.S * g.R * L;
  float bgv = 0.f, mu = 0.f, sigma = 0.f, bwv = 0.f, z = 0.f;
  int per = 1;
  if (live && lane < L) {
    bgv = g.bg[link0 + lane];
    mu = g.mu[bg_off + lane];
    sigma = g.sigma[bg_off + lane];
    bwv = g.bw[(size_t)s * L + lane];
    per = g.period[(size_t)s * L + lane];
    z = g.noise[link0 + lane];
  }
  int tc = 0, steps = 0, mt = 0;
  if (live) {
    tc = g.t[e];
    steps = g.steps[e];
    mt = g.max_ticks[s];
  }
  stage_tables(tb, g.tables, s, T, g.P, L);
  if (!live) return;  // no block barrier follows
  WarpScratch& ws = scratch[warp];

  for (int k = 0; k < g.K; ++k) {
    unsigned dball[kSlots];
    unsigned all_done = kFull;
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      dball[j] = __ballot_sync(kFull, dn[j]);
      all_done &= dball[j];
    }
    if (tc >= mt || all_done == kFull) break;  // dead elements never change again

    if (lane < L) {
      const float fresh = fmaxf(__fmaf_rn(sigma, z, mu), 0.f);
      if (tc % per == 0) bgv = fresh;
      // the next tick's normal, loaded while this tick runs
      if (k + 1 < g.K) z = g.noise[(size_t)(k + 1) * noise_stride + link0 + lane];
    }
    float av[kSlots], xf[kSlots];
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int i = lane + j * kWarp;
      bool act = false;
      if (i < T) {
        bool dep_ok = dp[j] < 0 || ballot_bit(dball, dp[j]);
        act = !dn[j] && rel[j] <= tc && dep_ok;
      }
      av[j] = act ? 1.f : 0.f;
      xf[j] = 0.f;
    }
    fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, lane, T, L);
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
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
  for (int j = 0; j < kSlots; ++j) {
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

template <int kSlots>
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_tick_kernel(TickArgs g) {
  __shared__ ScenarioTables tb;
  __shared__ WarpScratch scratch[kBankWarps];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, P = g.P, L = g.L;

  const size_t e = (size_t)s * g.R + r;
  const size_t leg0 = e * T;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  float av[kSlots], keep[kSlots], rem[kSlots], xf[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    av[j] = keep[j] = rem[j] = xf[j] = 0.f;
    if (live && i < T) {
      av[j] = g.active[leg0 + i];
      keep[j] = keep_row[i];
      rem[j] = g.remaining[leg0 + i];
    }
  }
  float bgv = 0.f, bwv = 0.f;
  if (live && lane < L) {
    bgv = g.bg[e * L + lane];
    bwv = g.bw[(size_t)s * L + lane];
  }
  stage_tables(tb, g.tables, s, T, P, L);
  if (!live) return;
  WarpScratch& ws = scratch[warp];
  fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, lane, T, L);
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    if (i < T) g.xfer[leg0 + i] = xf[j];
  }
  // processes past the last one with a leg sum nothing
  for (int p = lane; p < P; p += kWarp) g.proc_xfer[e * P + p] = p < tb.n_proc ? ws.px[p] : 0.f;
  if (lane < L) g.link_xfer[e * L + lane] = ws.lx[lane];
}

// The per-process and per-link sums of v, by segment_sums: one warp an
// element, its legs strided over the lanes.
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_sums_kernel(SumsArgs g) {
  __shared__ ScenarioTables tb;
  __shared__ WarpScratch scratch[kBankWarps];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, P = g.P, L = g.L;
  const size_t e = (size_t)s * g.R + r;
  WarpScratch& ws = scratch[warp];
  if (live) {
    for (int i = lane; i < T; i += kWarp) ws.x[i] = g.v[e * T + i];
  }
  stage_tables(tb, g.tables, s, T, P, L);  // its barriers publish ws.x too
  if (!live) return;
  segment_sums(tb, ws, lane, L);
  for (int p = lane; p < P; p += kWarp) g.proc[e * P + p] = p < tb.n_proc ? ws.px[p] : 0.f;
  if (lane < L) g.link[e * L + lane] = ws.lx[lane];
}

// Launches kernel<ceil(T / 32)> (kSlots = 1 .. 4).
#define BANK_LAUNCH(kernel, T, grid, stream, args)                              \
  switch (((T) + kWarp - 1) / kWarp) {                                          \
    case 1: kernel<1><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    case 2: kernel<2><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    case 3: kernel<3><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    default: kernel<4><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
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

// Blocks of each bank kernel resident on one SM at T legs a scenario, and
// the warps (elements) of one block.
int grid_tick_bank_occupancy(int T, int* fused_blocks, int* tick_blocks, int* warps) {
  *warps = kBankWarps;
  const int threads = kBankWarps * kWarp;
  int err = 0;
  switch ((T + kWarp - 1) / kWarp) {
#define BANK_OCCUPANCY(n)                                                              \
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(fused_blocks, bank_fused_kernel<n>, threads, 0); \
    if (err == 0) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(tick_blocks, bank_tick_kernel<n>, threads, 0);
    case 1: BANK_OCCUPANCY(1) break;
    case 2: BANK_OCCUPANCY(2) break;
    case 3: BANK_OCCUPANCY(3) break;
    default: BANK_OCCUPANCY(4) break;
#undef BANK_OCCUPANCY
  }
  return err;
}

int grid_tick_bank_fused_launch(
    const int* t, const int* steps, const float* remaining,
    const unsigned char* done, const unsigned char* started,
    const int* t_start, const int* t_end, const float* conth,
    const float* conpr, const float* bg, const float* noise, const float* mu,
    const float* sigma, int bg_rstride, const int* release, const int* dep,
    const int* period, const int* max_ticks, const float* keep,
    int keep_rstride, const float* bw, const int* tables, int* t_out,
    int* steps_out, float* remaining_out, unsigned char* done_out,
    unsigned char* started_out, int* t_start_out, int* t_end_out,
    float* conth_out, float* conpr_out, float* bg_out, int S, int R, int T,
    int P, int L, int K, void* stream) {
  if (T < 1 || T > kMaxT || P > kMaxP || L > kMaxL || S < 1 || R < 1 || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FusedArgs g{t, steps, remaining, done, started, t_start, t_end, conth,
              conpr, bg, noise, mu, sigma, bg_rstride, release, dep, period,
              max_ticks, keep, keep_rstride, bw, tables, t_out, steps_out,
              remaining_out, done_out,
              started_out, t_start_out, t_end_out, conth_out, conpr_out,
              bg_out, S, R, T, P, L, K};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  BANK_LAUNCH(bank_fused_kernel, T, grid, stream, g)
  return (int)cudaGetLastError();
}

int grid_tick_bank_launch(
    const float* active, const float* remaining, const float* keep,
    int keep_rstride, const float* bg, const float* bw, const int* tables,
    float* xfer, float* proc_xfer, float* link_xfer, int S, int R, int T,
    int P, int L, void* stream) {
  if (T < 1 || T > kMaxT || P > kMaxP || L > kMaxL || S < 1 || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  TickArgs g{active, remaining, keep, keep_rstride, bg, bw, tables, xfer,
             proc_xfer, link_xfer, S, R, T, P, L};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  BANK_LAUNCH(bank_tick_kernel, T, grid, stream, g)
  return (int)cudaGetLastError();
}

int grid_tick_bank_sums_launch(const float* v, const int* tables, float* proc,
                               float* link, int S, int R, int T, int P, int L,
                               void* stream) {
  if (T < 1 || T > kMaxT || P > kMaxP || L > kMaxL || S < 1 || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  SumsArgs g{v, tables, proc, link, S, R, T, P, L};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  bank_sums_kernel<<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(g);
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
