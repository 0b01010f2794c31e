// Fair-share grid-tick kernels, for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernels in
// src/repro/kernels/grid_tick.py:
//   - bank_fused_kernel  <- grid_tick_bank_fused_pallas / _bank_fused_kernel
//     (K fair-share ticks per launch, the carry resident on chip);
//   - bank_tick_kernel   <- grid_tick_bank_pallas / _bank_tick_kernel
//     (one tick -> xfer, proc_xfer, link_xfer; the leap engine's rates),
//     and <- grid_tick_pallas / _tick_kernel (one tick of B simulations of
//     one campaign): a campaign is a bank of one scenario whose B
//     simulations are its replicas, so both run this kernel;
// and one that has no Pallas counterpart:
//   - bank_sums_kernel: the leap steps' per-process and per-link sums of the
//     event step's last tick (the reference takes them as one-hot dots,
//     src/repro/kernels/ref.py:307 for a bank, src/repro/core/engine.py:220
//     for one campaign), in the order of the other two.
// Past the bank limits (T <= 128, P <= 128, L <= 32) the three run
// bank_fused_wide_kernel, bank_tick_wide_kernel and bank_sums_wide_kernel,
// on tables in dynamic shared memory, up to T <= 1,024, P <= 1,024, L <=
// 256 a scenario (see "Wide tables" below).
//
// What bounds them on the card. Per element and tick the work is a few
// hundred scalar operations on ~T legs, P processes and L links, so neither
// kernel comes near the tensor cores or the fp32 peak, and the one-tick
// kernel moves its inputs and outputs once. What bounds both in practice is
// the warp's instruction stream: each tick is a chain of dependent segment
// sums inside one warp, so the cost is issue slots and the latency between
// them, which more resident warps hide.
//
// Layout. One warp owns one (scenario, replica) element, and the whole carry
// stays in registers for the K loop. Each block holds the warps of one
// scenario and stages that scenario's tables in shared memory once
// (ref.BankTables.packed: the process and link of each leg, the legs of each
// process and the processes of each link as ascending lists), and builds from
// the lists one bit mask per process over the legs and one per link over the
// processes, a thread a list entry (atomicOr), so no thread walks a list
// while the block waits. A warp leaves its loop as soon as its element is finished or
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
//   - xfer per link: lane k walks the processes of links k, k + 32, ... and
//     adds their sums. A link's sum walks its processes, not its legs: on an
//     L = 1 campaign no lane walks all T legs while the others wait; the
//     longest walk is the largest process or the busiest link (Section 5's
//     106 legs on one link: ~20 legs, then 11 processes).
// The float sums run one term at a time from 0.0 with __fadd_rn, in list
// order, with no float atomics: bitwise what ref.grid_tick_bank_indexed
// (ref.grid_tick_indexed for one campaign) computes, run to run and for
// every window size K. A link that carries one process sums to exactly that
// process's sum, so its ConPr adds exact zeros.
// At the main bank (S 1,024, padded T 93, P 80, L 11; a scenario has on
// average 17 legs, 12 processes and 2.5 links, the longest process list ~4
// legs and the busiest link ~7 processes) a tick should cost ~300-400 warp
// instructions an element; a compare-scan of every segment over the padded
// T, P and L would cost ~5,000.
//
// Wide tables. Past the bank limits the bit masks would not fit (P x T / 32
// words: 128 KB at a 1,024-leg campaign), so the wide kernels stage the
// packed lists alone in dynamic shared memory and work in list order:
// position k of the process lists is entry k of proc_legs, so a process's
// legs are the run of positions [proc_ptr[p], proc_ptr[p + 1]), and a
// link's processes the run [link_proc_ptr[l], link_proc_ptr[l + 1]) of
// the link lists. A count is the popcount of a run of ballot words taken
// by position (run_counts), and a sum folds a contiguous row gathered in
// list order (run_sum, run_sums): the same terms in the same order as
// segment_sums, with no lane walking a list through its indices. The
// one-tick and sums kernels gather their rows into list order in shared
// memory, a lane-strided pass each. The fused kernel, which runs K ticks,
// stages the list order once (WideOrder, which also places the legs and
// processes in no list) and holds the legs and processes at positions
// lane, lane + 32, ... in up to 8 register slots and its links in
// registers (templated on the slots), so at T, P <= 256 and L <= 32
// nothing of the carry touches device memory inside the tick loop; every
// per-slot step loads for all slots before it computes, so one warp's
// slots overlap their latencies. Its general instance takes the rest:
// links to 256, and the legs past 256 keep their carry in the element's
// rows of the output in device memory.
//
// Rounding follows the plain PyTorch version (repro_torch/kernels/ref.py):
// every float operation is written as an explicit round-to-nearest intrinsic
// and the library is built with --fmad=false; the one fused multiply-add,
// mu + sigma * noise, is __fmaf_rn, as the plain version's fma().

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;
constexpr int kMaxP = 128;
constexpr int kMaxL = 32;
constexpr int kMaxSlots = kMaxT / kWarp;  // leg slots a lane
constexpr int kProcWords = kMaxP / kWarp;
// Warps (elements) per block of the bank kernels: the scenario's tables are
// staged once per block. ~5 KB of tables and ~1.8 KB of scratch a warp.
constexpr int kBankWarps = 4;
// The wide kernels' limits: a scenario (or one campaign) of up to 1,024 legs
// and processes and 256 links (~154 KB of dynamic shared memory at the limits
// for the one-tick and sums kernels, ~107 KB for the fused kernel).
constexpr int kWideT = 1024;
constexpr int kWideP = 1024;
constexpr int kWideL = 256;
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

// The wide kernels' view of one scenario's tables in dynamic shared memory
// (the packed lists, no masks).
struct WideTables {
  const int* proc_of_leg;
  const int* link_of_leg;
  const int* proc_ptr;
  const int* proc_legs;
  const int* link_proc_ptr;
  const int* link_procs;
};

// The wide one-tick and sums kernels' rows of a warp in dynamic shared
// memory. By leg: the tick's active flags (the sums kernel's values), keeps,
// remaining and transfers; the values to sum gathered by position in the
// process lists; by process, the active legs and the sums; the sums
// gathered by position in the link lists; by link, the per-process
// bandwidth; the ballots of the active legs and of the active processes by
// position.
struct WideRows {
  float* a;       // [T]
  float* keep;    // [T]
  float* rem;     // [T]
  float* x;       // [T]
  float* xs;      // [T]
  int* thr;       // [P]
  float* px;      // [P]
  float* pxs;     // [P]
  float* ppbw;    // [L]
  unsigned* aw;   // [ceil(T / 32)]
  unsigned* pw;   // [ceil(P / 32)]
};

__host__ __device__ inline int wide_row_words(int T, int P, int L) {
  return 5 * T + 3 * P + L + (T + kWarp - 1) / kWarp + (P + kWarp - 1) / kWarp;
}

// Dynamic shared memory of a wide block: the packed tables and kBankWarps
// rows of warp_words words each.
__host__ __device__ inline size_t wide_smem_bytes(int T, int P, int L, int warp_words) {
  return sizeof(int) * ((size_t)bank_table_words(T, P, L) + (size_t)kBankWarps * warp_words);
}

// 1 + the last process in any list of the staged lists, for one thread's
// share of the list entries (thread t takes entries t, t + blockDim.x, ...),
// reduced over the block into *n_proc (set to 1 before the caller's first
// barrier). With kMasks, also sets each entry's bit in its process's leg
// mask and its link's process mask: every entry at once, so no thread walks
// a list. A listed leg's process is its proc_of_leg; an entry's link is
// found in the link pointers (at most kMaxL + 1 of them).
template <bool kMasks>
__device__ void scan_lists(ScenarioTables& tb, int* n_proc, int P, int L) {
  int np = 0;
  const int n_legs = tb.proc_ptr[P];
  for (int k = threadIdx.x; k < n_legs; k += blockDim.x) {
    const int leg = tb.proc_legs[k];
    const int p = tb.proc_of_leg[leg];
    if constexpr (kMasks) atomicOr(&tb.leg_mask[p][leg / kWarp], 1u << (leg % kWarp));
    np = max(np, p + 1);
  }
  const int n_procs = tb.link_proc_ptr[L];
  for (int k = threadIdx.x; k < n_procs; k += blockDim.x) {
    const int p = tb.link_procs[k];  // a process with no leg still counts
    if constexpr (kMasks) {
      int l = 0;
      while (tb.link_proc_ptr[l + 1] <= k) ++l;
      atomicOr(&tb.proc_mask[l][p / kWarp], 1u << (p % kWarp));
    }
    np = max(np, p + 1);
  }
  np = __reduce_max_sync(kFull, np);
  if (threadIdx.x % kWarp == 0) atomicMax(n_proc, np);
}

// Stages scenario s's tables into tb, with the bit masks when kMasks (the
// sums kernel reads the lists alone).
template <bool kMasks>
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
  if constexpr (kMasks) {
    for (int i = threadIdx.x; i < P * kMaxSlots; i += blockDim.x) (&tb.leg_mask[0][0])[i] = 0u;
    for (int i = threadIdx.x; i < L * kProcWords; i += blockDim.x) (&tb.proc_mask[0][0])[i] = 0u;
  }
  if (threadIdx.x == 0) tb.n_proc = 1;
  __syncthreads();
  scan_lists<kMasks>(tb, &tb.n_proc, P, L);
  __syncthreads();
}

// The wide kernels' staging: the packed lists copied into smem (every
// thread of the block; its barrier publishes what the block wrote before).
__device__ WideTables stage_wide_tables(int* smem, const int* tables, int s, int T, int P, int L) {
  const int words = bank_table_words(T, P, L);
  const int* src = tables + (size_t)s * words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = src[i];
  WideTables tb;
  tb.proc_of_leg = smem;
  tb.link_of_leg = smem + T;
  tb.proc_ptr = smem + 2 * T;
  tb.proc_legs = tb.proc_ptr + P + 1;
  tb.link_proc_ptr = tb.proc_legs + T;
  tb.link_procs = tb.link_proc_ptr + L + 1;
  __syncthreads();
  return tb;
}

// Warp `warp`'s rows of the wide one-tick and sums kernels, after the
// tables.
__device__ WideRows wide_rows(int* smem, int warp, int T, int P, int L) {
  float* row = reinterpret_cast<float*>(smem + bank_table_words(T, P, L)) +
               (size_t)warp * wide_row_words(T, P, L);
  WideRows w;
  w.a = row;
  w.keep = w.a + T;
  w.rem = w.keep + T;
  w.x = w.rem + T;
  w.xs = w.x + T;
  w.thr = reinterpret_cast<int*>(w.xs + T);
  w.px = reinterpret_cast<float*>(w.thr + P);
  w.pxs = w.px + P;
  w.ppbw = w.pxs + P;
  w.aw = reinterpret_cast<unsigned*>(w.ppbw + L);
  w.pw = w.aw + (T + kWarp - 1) / kWarp;
  return w;
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
  for (int l = lane; l < L; l += kWarp) {
    float acc = 0.f;
    for (int k = tb.link_proc_ptr[l]; k < tb.link_proc_ptr[l + 1]; ++k) {
      acc = __fadd_rn(acc, ws.px[tb.link_procs[k]]);
    }
    ws.lx[l] = acc;
  }
  __syncwarp();
}

// The per-process bandwidth of link l: bw / max(campaign + max(bg, 0), 1).
__device__ inline float per_proc_bw(int campaign, float bg, float bw) {
  const float denom = fmaxf(__fadd_rn(__int2float_rn(campaign), fmaxf(bg, 0.f)), 1.f);
  return __fdiv_rn(bw, denom);
}

// The fair share of one tick for one element, from the lane's active flags
// av to its transfers xf and the warp's ws.px and ws.lx. av, keep, rem hold
// the lane's legs in its slots; bgv and bwv the lane's link.
template <int kSlots>
__device__ void fair_share(const ScenarioTables& tb, WarpScratch& ws,
                           const float (&av)[kSlots], const float (&keep)[kSlots],
                           const float (&rem)[kSlots], float (&xf)[kSlots],
                           float bgv, float bwv, int lane, int T, int L) {
  unsigned act[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) act[j] = __ballot_sync(kFull, av[j] > 0.f);
  const int np = tb.n_proc;
  // active legs per process (popcounts under its leg mask), and a ballot
  // of the active processes per word of 32
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
    ws.ppbw[lane] = per_proc_bw(c, bgv, bwv);
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

// One element's per-process and per-link sums out: processes past the last
// one in any list sum nothing.
__device__ void write_sums(const ScenarioTables& tb, const WarpScratch& ws, float* proc,
                           float* link, size_t e, int lane, int P, int L) {
  for (int p = lane; p < P; p += kWarp) proc[e * P + p] = p < tb.n_proc ? ws.px[p] : 0.f;
  for (int l = lane; l < L; l += kWarp) link[e * L + l] = ws.lx[l];
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
  stage_tables<true>(tb, g.tables, s, T, g.P, L);
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

// The wide fused kernel's view of a scenario in list order. Position q of
// leg_at is the q-th entry of the process lists, so the legs of process p
// are the run of positions [proc_ptr[p], proc_ptr[p + 1]); the legs in no
// list follow, in ascending order. proc_at does the same over the link
// lists (the processes of link l: [link_proc_ptr[l], link_proc_ptr[l + 1]));
// pos_of_leg and pos_of_proc invert the two.
struct WideOrder {
  int* leg_at;       // [T]
  int* pos_of_leg;   // [T]
  int* proc_at;      // [P]
  int* pos_of_proc;  // [P]
};

// Gives the members of [0, n) with no position yet (pos < 0) the positions
// from `next` on, in ascending order: one warp, a ballot a word of 32.
__device__ void place_rest(int* pos, int* at, int n, int next, int lane) {
  for (int i0 = 0; i0 < n; i0 += kWarp) {  // warp-uniform
    const int i = i0 + lane;
    const bool rest = i < n && pos[i] < 0;
    const unsigned b = __ballot_sync(kFull, rest);
    if (rest) {
      const int q = next + __popc(b & ((1u << lane) - 1u));
      pos[i] = q;
      at[q] = i;
    }
    next += __popc(b);
  }
}

// Stages the list order of a scenario whose tables tb are staged (every
// thread of the block).
__device__ WideOrder stage_wide_order(int* words, const WideTables& tb, int T, int P, int L) {
  WideOrder o{words, words + T, words + 2 * T, words + 2 * T + P};
  for (int i = threadIdx.x; i < T; i += blockDim.x) o.pos_of_leg[i] = -1;
  for (int i = threadIdx.x; i < P; i += blockDim.x) o.pos_of_proc[i] = -1;
  __syncthreads();
  const int n_legs = tb.proc_ptr[P], n_procs = tb.link_proc_ptr[L];
  for (int k = threadIdx.x; k < n_legs; k += blockDim.x) {
    o.leg_at[k] = tb.proc_legs[k];
    o.pos_of_leg[tb.proc_legs[k]] = k;
  }
  for (int k = threadIdx.x; k < n_procs; k += blockDim.x) {
    o.proc_at[k] = tb.link_procs[k];
    o.pos_of_proc[tb.link_procs[k]] = k;
  }
  __syncthreads();
  if (threadIdx.x < kWarp) {
    place_rest(o.pos_of_leg, o.leg_at, T, n_legs, threadIdx.x);
    place_rest(o.pos_of_proc, o.proc_at, P, n_procs, threadIdx.x);
  }
  __syncthreads();
  return o;
}

// The wide fused kernel's per-warp rows, by leg position q and process
// position r: each leg's transfer, each process's active legs and sum, each
// link's per-process bandwidth and sum; the ballots of the active legs, of
// the done legs (read past the slots) and of the active processes, one
// word per 32 positions; the active flags of the legs past the slots.
struct FusedRows {
  float* xs;      // [T]
  int* thr;       // [P]
  float* pxs;     // [P]
  float* ppbw;    // [L]
  float* lx;      // [L]
  unsigned* aw;   // [ceil(T / 32)]
  unsigned* dw;   // [ceil(T / 32)]
  unsigned* pw;   // [ceil(P / 32)]
  float* avp;     // [T - kWidePast]
};

// Leg (and process) slots a lane of the wide fused kernel holds at most:
// the legs past them live in device memory, the processes past them read
// their runs from shared memory.
constexpr int kWideSlots = 8;
constexpr int kWidePast = kWideSlots * kWarp;

__host__ __device__ inline int wide_fused_warp_words(int T, int P, int L) {
  const int words = (T + kWarp - 1) / kWarp;
  return T + 2 * P + 2 * L + 2 * words + (P + kWarp - 1) / kWarp +
         (T > kWidePast ? T - kWidePast : 0);
}

// Dynamic shared memory of the wide fused kernel: wide_smem_bytes' and the
// list order.
__host__ __device__ inline size_t wide_fused_smem_bytes(int T, int P, int L) {
  return wide_smem_bytes(T, P, L, wide_fused_warp_words(T, P, L)) + sizeof(int) * (2 * T + 2 * P);
}

__device__ FusedRows fused_rows(int* base, int warp, int T, int P, int L) {
  const int words = (T + kWarp - 1) / kWarp;
  float* row = reinterpret_cast<float*>(base) + (size_t)warp * wide_fused_warp_words(T, P, L);
  FusedRows w;
  w.xs = row;
  w.thr = reinterpret_cast<int*>(row + T);
  w.pxs = row + T + P;
  w.ppbw = w.pxs + P;
  w.lx = w.ppbw + L;
  w.aw = reinterpret_cast<unsigned*>(w.lx + L);
  w.dw = w.aw + words;
  w.pw = w.dw + words;
  w.avp = reinterpret_cast<float*>(w.pw + (P + kWarp - 1) / kWarp);
  return w;
}

// b[i] for a runtime i < N, from registers.
template <int N>
__device__ inline unsigned pick(const unsigned (&b)[N], int i) {
  unsigned v = b[0];
  #pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? b[j] : v;
  return v;
}

// The set bits of positions [b, e) of the ballot word at position `word`
// x 32 (bits, its value).
__device__ inline int word_count(unsigned bits, int word, int b, int e) {
  const int lo = max(b - word * kWarp, 0), hi = min(e - word * kWarp, kWarp);
  const unsigned m = hi - lo >= kWarp ? kFull : ((1u << max(hi - lo, 0)) - 1u) << lo;
  return __popc(bits & m);
}

// The set bits of the runs of positions [b[i], e[i]) of the ballot words w,
// every run of the lane at once: the first word of every run in lockstep,
// then, only where a run of the lane spans more, its other words.
template <int N>
__device__ inline void run_counts(const unsigned* w, const int (&b)[N], const int (&e)[N],
                                  int (&c)[N]) {
  bool more = false;
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    const int word = b[i] / kWarp;
    c[i] = word_count(e[i] > b[i] ? w[word] : 0u, word, b[i], e[i]);
    more |= e[i] > (word + 1) * kWarp;
  }
  if (more) {
    #pragma unroll
    for (int i = 0; i < N; ++i) {
      for (int word = b[i] / kWarp + 1; word * kWarp < e[i]; ++word) {
        c[i] += word_count(w[word], word, b[i], e[i]);
      }
    }
  }
}

// acc + row[b] + ... + row[e - 1], one term at a time in order, the loads
// of 16 terms issued ahead of their adds.
__device__ inline float run_sum(const float* row, int b, int e, float acc) {
  int k = b;
  for (; k + 16 <= e; k += 16) {
    float v[16];
    #pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = row[k + u];
    #pragma unroll
    for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, v[u]);
  }
  #pragma unroll 4
  for (; k < e; ++k) acc = __fadd_rn(acc, row[k]);
  return acc;
}

// row[b[i]] + ... + row[e[i] - 1] for every run of the lane, one term at a
// time from 0.0 in order: the first two terms of every run in lockstep (a
// term past a run adds +0.0, which leaves a sum from 0.0 unchanged, since
// such a sum is never -0.0), then, only where a run of the lane is longer,
// its rest by run_sum.
template <int N>
__device__ inline void run_sums(const float* row, const int (&b)[N], const int (&e)[N],
                                float (&out)[N]) {
  constexpr int kHead = 2;
  bool more = false;
  #pragma unroll
  for (int i = 0; i < N; ++i) {
    out[i] = 0.f;
    more |= e[i] - b[i] > kHead;
  }
  #pragma unroll
  for (int t = 0; t < kHead; ++t) {
    float v[N];
    #pragma unroll
    for (int i = 0; i < N; ++i) v[i] = b[i] + t < e[i] ? row[b[i] + t] : 0.f;
    #pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __fadd_rn(out[i], v[i]);
  }
  if (more) {
    #pragma unroll
    for (int i = 0; i < N; ++i) {
      if (e[i] - b[i] > kHead) out[i] = run_sum(row, b[i] + kHead, e[i], out[i]);
    }
  }
}

// Whether the leg at position d >= 0 is done: from the slots' ballots,
// word d / 32 of which lane d / 32 holds as `mine`, past them (kGeneral)
// from the warp's row.
template <bool kGeneral>
__device__ inline bool done_at(unsigned mine, const unsigned* dw, int d, int past) {
  const unsigned word = __shfl_sync(kFull, mine, (d / kWarp) % kWarp);
  if (kGeneral && d >= past) return (dw[d / kWarp] >> (d % kWarp)) & 1u;
  return (word >> (d % kWarp)) & 1u;
}

// num / d for d >= 1, as __fdiv_rn: a zero num (an inactive leg's share)
// is its own quotient, and takes no division, whose check sends a zero
// dividend down its slow path.
__device__ inline float share_div(float num, float d) {
  const bool zero = num == 0.f;
  const float q = __fdiv_rn(zero ? 1.f : num, d);
  return zero ? num : q;
}

// bank_fused_kernel on wide tables (past T 128, P 128 or L 32). A lane holds
// the legs at positions lane, lane + 32, ... of the list order (WideOrder)
// in kSlots register slots, the runs of the processes at positions lane,
// lane + 32, ... (kSlots of them) and every link lane, lane + 32, ...
// (kLinkSlots) in registers, so on T <= 256, P <= 256, L <= 32 (kLinkSlots
// = 1) nothing of the carry touches device memory inside the tick loop.
// In list order a process's legs and a link's processes are runs of
// positions, so a count is the popcount of a run of ballot words and a sum
// runs over a contiguous row: no lane walks a list through its indices.
// kLinkSlots = 8 is the general instance: up to 256 links, processes past
// 256 read their runs from shared memory, and the legs past the 256 slots
// keep their carry in the element's rows of the output in device memory
// (copied from the input once, then updated in place by the lane that
// owns the position).
template <int kSlots, int kLinkSlots>
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_fused_wide_kernel(FusedArgs g) {
  extern __shared__ int smem[];
  constexpr bool kGeneral = kLinkSlots > 1;
  constexpr int kPast = kSlots * kWarp;  // the first leg position past the slots
  constexpr int kProcSlots = kSlots;
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, P = g.P, L = g.L;

  const size_t e = (size_t)s * g.R + r;
  const size_t leg0 = e * T;
  const size_t link0 = e * L;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  const size_t bg_off = (size_t)s * (g.bg_rstride ? (size_t)g.R * L : L)
                        + (size_t)r * g.bg_rstride;
  const size_t noise_stride = (size_t)g.S * g.R * L;
  // the lane's links, loaded before the block stages its tables
  float bgv[kLinkSlots], mu[kLinkSlots], sigma[kLinkSlots], bwv[kLinkSlots], z[kLinkSlots];
  int per[kLinkSlots];
  #pragma unroll
  for (int m = 0; m < kLinkSlots; ++m) {
    const int l = lane + m * kWarp;
    bgv[m] = mu[m] = sigma[m] = bwv[m] = z[m] = 0.f;
    per[m] = 1;
    if (live && l < L) {
      bgv[m] = g.bg[link0 + l];
      mu[m] = g.mu[bg_off + l];
      sigma[m] = g.sigma[bg_off + l];
      bwv[m] = g.bw[(size_t)s * L + l];
      per[m] = g.period[(size_t)s * L + l];
      z[m] = g.noise[link0 + l];
    }
  }
  int tc = 0, steps = 0, mt = 0;
  if (live) {
    tc = g.t[e];
    steps = g.steps[e];
    mt = g.max_ticks[s];
  }
  const WideTables tb = stage_wide_tables(smem, g.tables, s, T, P, L);
  int* order_words = smem + bank_table_words(T, P, L);
  const WideOrder o = stage_wide_order(order_words, tb, T, P, L);
  if (!live) return;  // no block barrier follows
  const FusedRows w = fused_rows(order_words + 2 * T + 2 * P, warp, T, P, L);
  const int words = (T + kWarp - 1) / kWarp;

  // the lane's legs: carry, constants, and where their process, link and
  // dependency sit
  float rem[kSlots], cth[kSlots], cpr[kSlots], keep[kSlots];
  int tst[kSlots], ten[kSlots], rel[kSlots], dpos[kSlots], rp[kSlots], lol[kSlots];
  bool dn[kSlots], st[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = lane + j * kWarp;
    if (q < T) {
      const int i = o.leg_at[q];
      rem[j] = g.remaining[leg0 + i];
      cth[j] = g.conth[leg0 + i];
      cpr[j] = g.conpr[leg0 + i];
      keep[j] = keep_row[i];
      tst[j] = g.t_start[leg0 + i];
      ten[j] = g.t_end[leg0 + i];
      dn[j] = g.done[leg0 + i] != 0;
      st[j] = g.started[leg0 + i] != 0;
      rel[j] = g.release[(size_t)s * T + i];
      const int d = g.dep[(size_t)s * T + i];
      dpos[j] = d < 0 ? -1 : o.pos_of_leg[d];
      rp[j] = o.pos_of_proc[tb.proc_of_leg[i]];
      lol[j] = tb.link_of_leg[i];
    } else {  // lane slots past the last leg are inert and born done
      rem[j] = cth[j] = cpr[j] = keep[j] = 0.f;
      tst[j] = ten[j] = rel[j] = rp[j] = lol[j] = 0;
      dpos[j] = -1;
      dn[j] = true;
      st[j] = false;
    }
  }
  // the runs of the lane's processes and links
  int pb[kProcSlots], pe[kProcSlots], lb[kLinkSlots], le[kLinkSlots];
  #pragma unroll
  for (int i = 0; i < kProcSlots; ++i) {
    const int q = lane + i * kWarp;
    pb[i] = pe[i] = 0;
    if (q < P) {
      pb[i] = tb.proc_ptr[o.proc_at[q]];
      pe[i] = tb.proc_ptr[o.proc_at[q] + 1];
    }
  }
  #pragma unroll
  for (int m = 0; m < kLinkSlots; ++m) {
    const int l = lane + m * kWarp;
    lb[m] = l < L ? tb.link_proc_ptr[l] : 0;
    le[m] = l < L ? tb.link_proc_ptr[l + 1] : 0;
  }
  if constexpr (kGeneral) {
    for (int q = lane + kPast; q < T; q += kWarp) {
      const size_t i = leg0 + o.leg_at[q];
      g.remaining_out[i] = g.remaining[i];
      g.done_out[i] = g.done[i];
      g.started_out[i] = g.started[i];
      g.t_start_out[i] = g.t_start[i];
      g.t_end_out[i] = g.t_end[i];
      g.conth_out[i] = g.conth[i];
      g.conpr_out[i] = g.conpr[i];
    }
  }

  // each link's phase in its refresh period, tc % period, carried
  int phase[kLinkSlots];
  #pragma unroll
  for (int m = 0; m < kLinkSlots; ++m) phase[m] = tc % per[m];
  const int pwords = (P + kWarp - 1) / kWarp;

  // Every per-slot step below loads for all slots first and branches on no
  // slot, so the slots' latencies overlap: an inert slot (past T) is done,
  // inactive and reads entry 0. The "tick_timers:" lines mark the start of
  // the tick loop, where each section of a tick ends and the end of the
  // loop, for tools/tick_timers.py; they compile to nothing and stay with
  // the sections they close.
  // tick_timers: start
  for (int k = 0; k < g.K; ++k) {
    // the done ballot of every position: the slots', then past them 32 at
    // a time from device memory (positions past T count as done)
    unsigned dball[kSlots];
    unsigned all_done = kFull;
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      dball[j] = __ballot_sync(kFull, dn[j]);
      all_done &= dball[j];
    }
    if constexpr (kGeneral) {
      for (int v = kSlots; v < words; ++v) {  // warp-uniform
        const int q = v * kWarp + lane;
        const unsigned b = __ballot_sync(kFull, q >= T || g.done_out[leg0 + o.leg_at[q]] != 0);
        if (lane == 0) w.dw[v] = b;
        all_done &= b;
      }
    }
    if (tc >= mt || all_done == kFull) break;  // dead elements never change again
    // tick_timers: done_ballot

    #pragma unroll
    for (int m = 0; m < kLinkSlots; ++m) {
      const float fresh = fmaxf(__fmaf_rn(sigma[m], z[m], mu[m]), 0.f);
      if (phase[m] == 0) bgv[m] = fresh;
      phase[m] = phase[m] + 1 == per[m] ? 0 : phase[m] + 1;
      // the next tick's normal, loaded while this tick runs
      if (k + 1 < g.K && lane + m * kWarp < L) {
        z[m] = g.noise[(size_t)(k + 1) * noise_stride + link0 + lane + m * kWarp];
      }
    }
    if constexpr (kGeneral) __syncwarp();  // w.dw
    // tick_timers: bg_refresh
    // active legs, and their ballots by position
    const unsigned done_mine = pick(dball, lane);
    float av[kSlots], xf[kSlots];
    unsigned ab[kSlots];
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool dep_ok =
          (dpos[j] < 0) | done_at<kGeneral>(done_mine, w.dw, max(dpos[j], 0), kPast);
      const bool act = !dn[j] & (rel[j] <= tc) & dep_ok;
      av[j] = act ? 1.f : 0.f;
      ab[j] = __ballot_sync(kFull, act);
    }
    if (lane < min(words, kSlots)) w.aw[lane] = pick(ab, lane);
    if constexpr (kGeneral) {
      for (int v = kSlots; v < words; ++v) {  // warp-uniform
        const int q = v * kWarp + lane;
        const int i = q < T ? o.leg_at[q] : 0;
        const int d = q < T ? g.dep[(size_t)s * T + i] : -1;
        const bool dep_ok =
            (d < 0) | done_at<kGeneral>(done_mine, w.dw, o.pos_of_leg[max(d, 0)], kPast);
        bool act = false;
        if (q < T) {
          act = g.done_out[leg0 + i] == 0 && g.release[(size_t)s * T + i] <= tc && dep_ok;
          w.avp[q - kPast] = act ? 1.f : 0.f;
        }
        const unsigned b = __ballot_sync(kFull, act);
        if (lane == 0) w.aw[v] = b;
      }
    }
    __syncwarp();
    // tick_timers: activity
    // active legs per process (popcounts of its run), a ballot of the
    // active processes by position
    int pc[kProcSlots];
    unsigned pb_act[kProcSlots];
    run_counts(w.aw, pb, pe, pc);
    #pragma unroll
    for (int i = 0; i < kProcSlots; ++i) {
      pb_act[i] = __ballot_sync(kFull, pc[i] > 0);  // a slot past P counts 0
      if (lane + i * kWarp < P) w.thr[lane + i * kWarp] = pc[i];
    }
    if (lane < min(pwords, kProcSlots)) w.pw[lane] = pick(pb_act, lane);
    if constexpr (kGeneral) {
      for (int i = kProcSlots; i < pwords; ++i) {  // warp-uniform
        const int q = lane + i * kWarp;
        int c[1] = {0}, b[1] = {0}, e1[1] = {0};
        if (q < P) {
          b[0] = tb.proc_ptr[o.proc_at[q]];
          e1[0] = tb.proc_ptr[o.proc_at[q] + 1];
        }
        run_counts(w.aw, b, e1, c);
        if (q < P) w.thr[q] = c[0];
        const unsigned bt = __ballot_sync(kFull, c[0] > 0);
        if (lane == 0) w.pw[i] = bt;
      }
    }
    __syncwarp();
    // tick_timers: proc_counts
    // active processes per link, fair share per process
    int lc[kLinkSlots];
    run_counts(w.pw, lb, le, lc);
    #pragma unroll
    for (int m = 0; m < kLinkSlots; ++m) {
      const int l = lane + m * kWarp;
      if (l < L) w.ppbw[l] = per_proc_bw(lc[m], bgv[m], bwv[m]);
    }
    __syncwarp();
    // tick_timers: link_counts
    // the transfers, by position
    float thr_leg[kSlots], pp[kSlots];
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      thr_leg[j] = __int2float_rn(w.thr[rp[j]]);
      pp[j] = w.ppbw[lol[j]];
    }
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const float chunk = share_div(__fmul_rn(__fmul_rn(av[j], keep[j]), pp[j]),
                                    fmaxf(thr_leg[j], 1.f));
      xf[j] = fminf(rem[j], chunk);
    }
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (lane + j * kWarp < T) w.xs[lane + j * kWarp] = xf[j];
    }
    if constexpr (kGeneral) {
      for (int q = lane + kPast; q < T; q += kWarp) {
        const int i = o.leg_at[q];
        const float threads_leg =
            fmaxf(__int2float_rn(w.thr[o.pos_of_proc[tb.proc_of_leg[i]]]), 1.f);
        const float chunk = share_div(
            __fmul_rn(__fmul_rn(w.avp[q - kPast], keep_row[i]), w.ppbw[tb.link_of_leg[i]]),
            threads_leg);
        w.xs[q] = fminf(g.remaining_out[leg0 + i], chunk);
      }
    }
    __syncwarp();
    // tick_timers: shares
    // the sums, in list order from 0.0: a process over its legs' run, a
    // link over its processes'
    float ps[kProcSlots];
    run_sums(w.xs, pb, pe, ps);
    #pragma unroll
    for (int i = 0; i < kProcSlots; ++i) {
      if (lane + i * kWarp < P) w.pxs[lane + i * kWarp] = ps[i];
    }
    if constexpr (kGeneral) {
      for (int q = lane + kProcSlots * kWarp; q < P; q += kWarp) {
        const int p = o.proc_at[q];
        w.pxs[q] = run_sum(w.xs, tb.proc_ptr[p], tb.proc_ptr[p + 1], 0.f);
      }
    }
    __syncwarp();
    // tick_timers: proc_sums
    float ls[kLinkSlots];
    run_sums(w.pxs, lb, le, ls);
    #pragma unroll
    for (int m = 0; m < kLinkSlots; ++m) {
      if (lane + m * kWarp < L) w.lx[lane + m * kWarp] = ls[m];
    }
    __syncwarp();
    // tick_timers: link_sums
    float own_proc[kSlots], own_link[kSlots];
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      own_proc[j] = w.pxs[rp[j]];
      own_link[j] = w.lx[lol[j]];
    }
    #pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      cth[j] = __fadd_rn(cth[j], __fmul_rn(av[j], __fsub_rn(own_proc[j], xf[j])));
      cpr[j] = __fadd_rn(cpr[j], __fmul_rn(av[j], __fsub_rn(own_link[j], own_proc[j])));
      rem[j] = __fsub_rn(rem[j], xf[j]);
      const bool act = av[j] > 0.f;
      if (act && !st[j]) tst[j] = tc;
      st[j] = st[j] || act;
      if (act && rem[j] <= 1e-6f) {
        dn[j] = true;
        ten[j] = tc + 1;
      }
    }
    // tick_timers: slot_update
    if constexpr (kGeneral) {
      for (int q = lane + kPast; q < T; q += kWarp) {
        const int i = o.leg_at[q];
        const size_t x = leg0 + i;
        const float a = w.avp[q - kPast];
        const float own_p = w.pxs[o.pos_of_proc[tb.proc_of_leg[i]]];
        const float own_l = w.lx[tb.link_of_leg[i]];
        g.conth_out[x] = __fadd_rn(g.conth_out[x], __fmul_rn(a, __fsub_rn(own_p, w.xs[q])));
        g.conpr_out[x] = __fadd_rn(g.conpr_out[x], __fmul_rn(a, __fsub_rn(own_l, own_p)));
        const float rm = __fsub_rn(g.remaining_out[x], w.xs[q]);
        g.remaining_out[x] = rm;
        const bool act = a > 0.f;
        if (act && g.started_out[x] == 0) g.t_start_out[x] = tc;
        if (act) g.started_out[x] = 1;
        if (act && rm <= 1e-6f) {
          g.done_out[x] = 1;
          g.t_end_out[x] = tc + 1;
        }
      }
    }
    // tick_timers: past_update
    tc += 1;
    steps += 1;
    __syncwarp();  // the next tick rewrites the rows
  }
  // tick_timers: save

  if (lane == 0) {
    g.t_out[e] = tc;
    g.steps_out[e] = steps;
  }
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = lane + j * kWarp;
    if (q < T) {
      const size_t i = leg0 + o.leg_at[q];
      g.remaining_out[i] = rem[j];
      g.done_out[i] = dn[j] ? 1 : 0;
      g.started_out[i] = st[j] ? 1 : 0;
      g.t_start_out[i] = tst[j];
      g.t_end_out[i] = ten[j];
      g.conth_out[i] = cth[j];
      g.conpr_out[i] = cpr[j];
    }
  }
  #pragma unroll
  for (int m = 0; m < kLinkSlots; ++m) {
    if (lane + m * kWarp < L) g.bg_out[link0 + lane + m * kWarp] = bgv[m];
  }
}

// One tick's inputs of element e in the lane's slots, loaded before the
// block stages its tables.
template <int kSlots>
__device__ void load_tick_legs(const TickArgs& g, bool live, int lane, size_t leg0,
                               const float* keep_row, float (&av)[kSlots],
                               float (&keep)[kSlots], float (&rem)[kSlots], float (&xf)[kSlots]) {
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    av[j] = keep[j] = rem[j] = xf[j] = 0.f;
    if (live && i < g.T) {
      av[j] = g.active[leg0 + i];
      keep[j] = keep_row[i];
      rem[j] = g.remaining[leg0 + i];
    }
  }
}

// One tick's outputs of element e: the slots' transfers, then the sums.
template <int kSlots>
__device__ void write_tick(const TickArgs& g, const ScenarioTables& tb, const WarpScratch& ws,
                           const float (&xf)[kSlots], size_t e, int lane) {
  const size_t leg0 = e * g.T;
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    if (i < g.T) g.xfer[leg0 + i] = xf[j];
  }
  write_sums(tb, ws, g.proc_xfer, g.link_xfer, e, lane, g.P, g.L);
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
  const int T = g.T, L = g.L;

  const size_t e = (size_t)s * g.R + r;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  float av[kSlots], keep[kSlots], rem[kSlots], xf[kSlots];
  load_tick_legs(g, live, lane, e * T, keep_row, av, keep, rem, xf);
  float bgv = 0.f, bwv = 0.f;
  if (live && lane < L) {
    bgv = g.bg[e * L + lane];
    bwv = g.bw[(size_t)s * L + lane];
  }
  stage_tables<true>(tb, g.tables, s, T, g.P, L);
  if (!live) return;
  WarpScratch& ws = scratch[warp];
  fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, lane, T, L);
  write_tick(g, tb, ws, xf, e, lane);
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
  const int T = g.T;
  const size_t e = (size_t)s * g.R + r;
  WarpScratch& ws = scratch[warp];
  if (live) {
    for (int i = lane; i < T; i += kWarp) ws.x[i] = g.v[e * T + i];
  }
  stage_tables<false>(tb, g.tables, s, T, g.P, g.L);  // its barriers publish ws.x too
  if (!live) return;
  segment_sums(tb, ws, lane, g.L);
  write_sums(tb, ws, g.proc, g.link, e, lane, g.P, g.L);
}

// The per-process and per-link sums of the values x (by leg) of element e
// under wide tables, into proc and link: x gathered in list order, each
// process's sum a fold of its run from 0.0, the process sums gathered in
// link-list order, each link's sum a fold of its run from 0.0. The same
// terms in the same order as segment_sums; a process in no list sums
// nothing.
__device__ void wide_sums(const WideTables& tb, const WideRows& w, const float* x, float* proc,
                          float* link, size_t e, int lane, int P, int L) {
  const int n_legs = tb.proc_ptr[P], n_procs = tb.link_proc_ptr[L];
  for (int k = lane; k < n_legs; k += kWarp) w.xs[k] = x[tb.proc_legs[k]];
  __syncwarp();
  for (int p = lane; p < P; p += kWarp) {
    const float sum = run_sum(w.xs, tb.proc_ptr[p], tb.proc_ptr[p + 1], 0.f);
    w.px[p] = sum;
    proc[e * P + p] = sum;
  }
  __syncwarp();
  for (int k = lane; k < n_procs; k += kWarp) w.pxs[k] = w.px[tb.link_procs[k]];
  __syncwarp();
  for (int l = lane; l < L; l += kWarp) {
    link[e * L + l] = run_sum(w.pxs, tb.link_proc_ptr[l], tb.link_proc_ptr[l + 1], 0.f);
  }
}

// bank_tick_kernel on wide tables, in list order: the element's rows
// staged by leg before the block stages its tables, the ballot of the
// active legs by position, each process's count the popcount of its run,
// the ballot of the active processes by position in the link lists, each
// link's count the popcount of its run; the shares by leg, then wide_sums.
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_tick_wide_kernel(TickArgs g) {
  extern __shared__ int smem[];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, P = g.P, L = g.L;

  const size_t e = (size_t)s * g.R + r;
  const float* keep_row = g.keep + (size_t)s * (g.keep_rstride ? (size_t)g.R * T : T)
                          + (size_t)r * g.keep_rstride;
  const WideRows w = wide_rows(smem, warp, T, P, L);
  if (live) {
    for (int i = lane; i < T; i += kWarp) {
      w.a[i] = g.active[e * T + i];
      w.keep[i] = keep_row[i];
      w.rem[i] = g.remaining[e * T + i];
    }
  }
  const WideTables tb = stage_wide_tables(smem, g.tables, s, T, P, L);  // publishes the rows
  if (!live) return;
  const int n_legs = tb.proc_ptr[P], n_procs = tb.link_proc_ptr[L];
  for (int v = 0; v * kWarp < n_legs; ++v) {  // warp-uniform
    const int k = v * kWarp + lane;
    const unsigned b = __ballot_sync(kFull, k < n_legs && w.a[tb.proc_legs[k]] > 0.f);
    if (lane == 0) w.aw[v] = b;
  }
  __syncwarp();
  for (int p = lane; p < P; p += kWarp) {
    const int b[1] = {tb.proc_ptr[p]}, en[1] = {tb.proc_ptr[p + 1]};
    int c[1];
    run_counts(w.aw, b, en, c);
    w.thr[p] = c[0];
  }
  __syncwarp();
  for (int v = 0; v * kWarp < n_procs; ++v) {  // warp-uniform
    const int k = v * kWarp + lane;
    const unsigned b = __ballot_sync(kFull, k < n_procs && w.thr[tb.link_procs[k]] > 0);
    if (lane == 0) w.pw[v] = b;
  }
  __syncwarp();
  for (int l = lane; l < L; l += kWarp) {
    const int b[1] = {tb.link_proc_ptr[l]}, en[1] = {tb.link_proc_ptr[l + 1]};
    int c[1];
    run_counts(w.pw, b, en, c);
    w.ppbw[l] = per_proc_bw(c[0], g.bg[e * L + l], g.bw[(size_t)s * L + l]);
  }
  __syncwarp();
  for (int i = lane; i < T; i += kWarp) {
    const float threads_leg = fmaxf(__int2float_rn(w.thr[tb.proc_of_leg[i]]), 1.f);
    const float chunk = share_div(
        __fmul_rn(__fmul_rn(w.a[i], w.keep[i]), w.ppbw[tb.link_of_leg[i]]), threads_leg);
    const float x = fminf(w.rem[i], chunk);
    w.x[i] = x;
    g.xfer[e * T + i] = x;
  }
  __syncwarp();
  wide_sums(tb, w, w.x, g.proc_xfer, g.link_xfer, e, lane, P, L);
}

// bank_sums_kernel on wide tables: the element's values staged by leg
// before the block stages its tables, then wide_sums.
__global__ void __launch_bounds__(kBankWarps * kWarp)
bank_sums_wide_kernel(SumsArgs g) {
  extern __shared__ int smem[];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.y * kBankWarps + warp;
  const bool live = r < g.R;  // warp-uniform
  const int T = g.T, P = g.P, L = g.L;
  const size_t e = (size_t)s * g.R + r;
  const WideRows w = wide_rows(smem, warp, T, P, L);
  if (live) {
    for (int i = lane; i < T; i += kWarp) w.a[i] = g.v[e * T + i];
  }
  const WideTables tb = stage_wide_tables(smem, g.tables, s, T, P, L);  // publishes w.a
  if (!live) return;
  wide_sums(tb, w, w.a, g.proc, g.link, e, lane, P, L);
}

// Launches kernel<ceil(T / 32)> (kSlots = 1 .. 4).
#define BANK_LAUNCH(kernel, T, grid, stream, args)                              \
  switch (((T) + kWarp - 1) / kWarp) {                                          \
    case 1: kernel<1><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    case 2: kernel<2><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    case 3: kernel<3><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
    default: kernel<4><<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(args); break; \
  }

// Whether a scenario of T legs, P processes and L links fits the static
// tables of the bank kernels, and whether the tick and sums launches take it.
inline bool fits_bank(int T, int P, int L) { return T <= kMaxT && P <= kMaxP && L <= kMaxL; }

inline bool bad_shape(int S, int R, int T, int P, int L) {
  return T < 1 || T > kWideT || P < 0 || P > kWideP || L < 0 || L > kWideL || S < 1 ||
         R < 1 || (R + kBankWarps - 1) / kBankWarps > 65535;
}

using FusedKernel = void (*)(FusedArgs);

// Whether the wide fused kernel runs its general instance <8, 8> at these
// pads, and else its slots: max(4, ceil(T / 32), ceil(P / 32)).
inline bool wide_general(int T, int P, int L) {
  return T > kWidePast || P > kWidePast || L > kWarp;
}
inline int wide_slots(int T, int P) {
  const int slots = ((T > P ? T : P) + kWarp - 1) / kWarp;
  return slots < 4 ? 4 : slots;
}

// The wide fused kernel's instance for a scenario's pads: wide_slots leg
// and process slots and one link slot on T <= 256, P <= 256, L <= 32, else
// the general instance.
FusedKernel wide_fused_kernel(int T, int P, int L) {
  if (wide_general(T, P, L)) return bank_fused_wide_kernel<kWideSlots, kWideSlots>;
  switch (wide_slots(T, P)) {
    case 5: return bank_fused_wide_kernel<5, 1>;
    case 6: return bank_fused_wide_kernel<6, 1>;
    case 7: return bank_fused_wide_kernel<7, 1>;
    case 8: return bank_fused_wide_kernel<8, 1>;
    default: return bank_fused_wide_kernel<4, 1>;
  }
}

// Raises every wide kernel's dynamic shared-memory limit past the default
// 48 KB to what it takes at the wide limits, once a device (at the first
// wide launch there), not on every launch.
cudaError_t raise_wide_limits() {
  static std::atomic<unsigned long long> raised{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || (raised.load() >> dev) & 1ull) return err;
  const int fused = (int)wide_fused_smem_bytes(kWideT, kWideP, kWideL);
  const int plain = (int)wide_smem_bytes(kWideT, kWideP, kWideL,
                                         wide_row_words(kWideT, kWideP, kWideL));
  for (FusedKernel k : {bank_fused_wide_kernel<4, 1>, bank_fused_wide_kernel<5, 1>,
                        bank_fused_wide_kernel<6, 1>, bank_fused_wide_kernel<7, 1>,
                        bank_fused_wide_kernel<8, 1>,
                        bank_fused_wide_kernel<kWideSlots, kWideSlots>}) {
    if (err == cudaSuccess) err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, fused);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bank_tick_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plain);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bank_sums_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plain);
  }
  if (err == cudaSuccess) raised |= 1ull << dev;
  return err;
}

// Launches a wide kernel with smem bytes of dynamic shared memory.
template <class Args>
int wide_launch(void (*kernel)(Args), const Args& g, dim3 grid, size_t smem, void* stream) {
  const cudaError_t err = raise_wide_limits();
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBankWarps * kWarp, smem, (cudaStream_t)stream>>>(g);
  return 0;
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

// Limits of the launches on wide tables (a scenario or one campaign).
int grid_tick_campaign_limits(int* max_t, int* max_p, int* max_l) {
  *max_t = kWideT;
  *max_p = kWideP;
  *max_l = kWideL;
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

// The wide instances at T legs, P processes and L links: the fused
// kernel's instance <fused_slots, fused_link_slots>, its dynamic shared
// memory and blocks resident on one SM, and the same of the one-tick
// kernel (the sums kernel takes the one-tick kernel's shared memory).
int grid_tick_wide_occupancy(int T, int P, int L, int* fused_slots, int* fused_link_slots,
                             int* fused_smem, int* fused_blocks, int* tick_smem,
                             int* tick_blocks) {
  if (bad_shape(1, 1, T, P, L)) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_wide_limits();
  *fused_slots = wide_general(T, P, L) ? kWideSlots : wide_slots(T, P);
  *fused_link_slots = wide_general(T, P, L) ? kWideSlots : 1;
  *fused_smem = (int)wide_fused_smem_bytes(T, P, L);
  *tick_smem = (int)wide_smem_bytes(T, P, L, wide_row_words(T, P, L));
  const int threads = kBankWarps * kWarp;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fused_blocks, wide_fused_kernel(T, P, L),
                                                        threads, *fused_smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(tick_blocks, bank_tick_wide_kernel,
                                                        threads, *tick_smem);
  }
  return (int)err;
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
  if (bad_shape(S, R, T, P, L) || K < 1) return (int)cudaErrorInvalidValue;
  FusedArgs g{t, steps, remaining, done, started, t_start, t_end, conth,
              conpr, bg, noise, mu, sigma, bg_rstride, release, dep, period,
              max_ticks, keep, keep_rstride, bw, tables, t_out, steps_out,
              remaining_out, done_out,
              started_out, t_start_out, t_end_out, conth_out, conpr_out,
              bg_out, S, R, T, P, L, K};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  if (fits_bank(T, P, L)) {
    BANK_LAUNCH(bank_fused_kernel, T, grid, stream, g)
  } else {
    const int err = wide_launch(wide_fused_kernel(T, P, L), g, grid,
                                wide_fused_smem_bytes(T, P, L), stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// One tick of S scenarios x R replicas (a campaign: S = 1, its B
// simulations the replicas); wide tables past the bank limits.
int grid_tick_bank_launch(
    const float* active, const float* remaining, const float* keep,
    int keep_rstride, const float* bg, const float* bw, const int* tables,
    float* xfer, float* proc_xfer, float* link_xfer, int S, int R, int T,
    int P, int L, void* stream) {
  if (bad_shape(S, R, T, P, L)) return (int)cudaErrorInvalidValue;
  TickArgs g{active, remaining, keep, keep_rstride, bg, bw, tables, xfer,
             proc_xfer, link_xfer, S, R, T, P, L};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  if (fits_bank(T, P, L)) {
    BANK_LAUNCH(bank_tick_kernel, T, grid, stream, g)
  } else {
    const int err = wide_launch(bank_tick_wide_kernel, g, grid,
                                wide_smem_bytes(T, P, L, wide_row_words(T, P, L)), stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

int grid_tick_bank_sums_launch(const float* v, const int* tables, float* proc,
                               float* link, int S, int R, int T, int P, int L,
                               void* stream) {
  if (bad_shape(S, R, T, P, L)) return (int)cudaErrorInvalidValue;
  SumsArgs g{v, tables, proc, link, S, R, T, P, L};
  dim3 grid(S, (R + kBankWarps - 1) / kBankWarps);
  if (fits_bank(T, P, L)) {
    bank_sums_kernel<<<grid, kBankWarps * kWarp, 0, (cudaStream_t)stream>>>(g);
  } else {
    const int err = wide_launch(bank_sums_wide_kernel, g, grid,
                                wide_smem_bytes(T, P, L, wide_row_words(T, P, L)), stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
