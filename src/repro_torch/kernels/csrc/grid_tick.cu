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
// Past the bank limits (T <= 128, P <= 128, L <= 32) the tick and the sums
// run bank_tick_wide_kernel and bank_sums_wide_kernel: the same routines on
// tables in dynamic shared memory, up to a campaign's T <= 1,024,
// P <= 1,024, L <= 256 (see "Wide tables" below).
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
// packed lists alone in dynamic shared memory, keep the first 128 legs of a
// lane in its 4 register slots and read the legs past them from device
// memory into the warp's shared row, and take the counts as integer walks
// of the lists over the warp's ballots (exact, so in any order). Their
// float sums are the same routines in the same order.
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
// Warps (elements) per block of the bank kernels: the scenario's tables are
// staged once per block. ~5 KB of tables and ~1.8 KB of scratch a warp.
constexpr int kBankWarps = 4;
// The wide kernels' limits: one campaign of up to 1,024 legs and processes
// and 256 links (~78 KB of dynamic shared memory at the limits).
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
  static constexpr bool kWide = false;
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
  static constexpr bool kWide = true;
  const int* proc_of_leg;
  const int* link_of_leg;
  const int* proc_ptr;
  const int* proc_legs;
  const int* link_proc_ptr;
  const int* link_procs;
  int n_proc;
};

// The wide kernels' per-warp rows in dynamic shared memory: WarpScratch's,
// and the warp's ballot of the active legs, one word per 32 legs.
struct WideScratch {
  float* x;
  int* threads;
  float* px;
  float* ppbw;
  float* lx;
  unsigned* act;
};

// One element's rows in device memory, for what a lane's registers do not
// hold under wide tables: the legs past its slots, every link.
struct LegRows {
  const float* active;     // [T]
  const float* keep;       // [T]
  const float* remaining;  // [T]
  const float* bg;         // [L]
  const float* bw;         // [L]
};

__host__ __device__ inline int wide_scratch_words(int T, int P, int L) {
  return T + 2 * P + 2 * L + (T + kWarp - 1) / kWarp;
}

// Dynamic shared memory of a wide block: the packed tables, n_proc, and
// kBankWarps scratch rows.
__host__ __device__ inline size_t wide_smem_bytes(int T, int P, int L) {
  return sizeof(int) * ((size_t)bank_table_words(T, P, L) + 1 +
                        (size_t)kBankWarps * wide_scratch_words(T, P, L));
}

// 1 + the last process in any list of the staged lists, for one thread's
// share of the list entries (thread t takes entries t, t + blockDim.x, ...),
// reduced over the block into *n_proc (set to 1 before the caller's first
// barrier). With kMasks, also sets each entry's bit in its process's leg
// mask and its link's process mask: every entry at once, so no thread walks
// a list. A listed leg's process is its proc_of_leg; an entry's link is
// found in the link pointers (at most kMaxL + 1 of them).
template <bool kMasks, class Tb>
__device__ void scan_lists(Tb& tb, int* n_proc, int P, int L) {
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

// The wide kernels' staging: the packed lists copied into smem, n_proc
// (as ScenarioTables') in the word after them.
__device__ WideTables stage_wide_tables(int* smem, const int* tables, int s, int T, int P, int L) {
  const int words = bank_table_words(T, P, L);
  const int* src = tables + (size_t)s * words;
  int* n_proc = smem + words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = src[i];
  if (threadIdx.x == 0) *n_proc = 1;
  WideTables tb;
  tb.proc_of_leg = smem;
  tb.link_of_leg = smem + T;
  tb.proc_ptr = smem + 2 * T;
  tb.proc_legs = tb.proc_ptr + P + 1;
  tb.link_proc_ptr = tb.proc_legs + T;
  tb.link_procs = tb.link_proc_ptr + L + 1;
  __syncthreads();
  scan_lists<false>(tb, n_proc, P, L);
  __syncthreads();
  tb.n_proc = *n_proc;
  return tb;
}

// Warp `warp`'s rows, after the tables and n_proc.
__device__ WideScratch wide_scratch(int* smem, int warp, int T, int P, int L) {
  float* row = reinterpret_cast<float*>(smem + bank_table_words(T, P, L) + 1) +
               (size_t)warp * wide_scratch_words(T, P, L);
  WideScratch ws;
  ws.x = row;
  ws.threads = reinterpret_cast<int*>(row + T);
  ws.px = row + T + P;
  ws.ppbw = ws.px + P;
  ws.lx = ws.ppbw + L;
  ws.act = reinterpret_cast<unsigned*>(ws.lx + L);
  return ws;
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
template <class Tb, class Ws>
__device__ void segment_sums(const Tb& tb, Ws& ws, int lane, int L) {
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
// the lane's legs in its slots; bgv and bwv the lane's link. Under wide
// tables the legs past the slots and every link come from `more`, and the
// transfers of the former stay in ws.x.
template <int kSlots, class Tb, class Ws>
__device__ void fair_share(const Tb& tb, Ws& ws,
                           const float (&av)[kSlots], const float (&keep)[kSlots],
                           const float (&rem)[kSlots], float (&xf)[kSlots],
                           float bgv, float bwv, const LegRows& more, int lane, int T, int L) {
  unsigned act[kSlots];
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) act[j] = __ballot_sync(kFull, av[j] > 0.f);
  const int np = tb.n_proc;
  if constexpr (!Tb::kWide) {
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
  } else {
    // the warp's ballot of every leg: the slots', then 32 legs at a time
    // past them; then each count an integer walk of a list over it
    const int words = (T + kWarp - 1) / kWarp;
    if (lane == 0) {
      #pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j < words) ws.act[j] = act[j];
      }
    }
    for (int w = kSlots; w < words; ++w) {  // warp-uniform
      const int i = w * kWarp + lane;
      const unsigned b = __ballot_sync(kFull, i < T && more.active[i] > 0.f);
      if (lane == 0) ws.act[w] = b;
    }
    __syncwarp();
    for (int p = lane; p < np; p += kWarp) {
      int c = 0;
      for (int k = tb.proc_ptr[p]; k < tb.proc_ptr[p + 1]; ++k) {
        const int leg = tb.proc_legs[k];
        c += (ws.act[leg / kWarp] >> (leg % kWarp)) & 1u;
      }
      ws.threads[p] = c;
    }
    __syncwarp();
    for (int l = lane; l < L; l += kWarp) {
      int c = 0;
      for (int k = tb.link_proc_ptr[l]; k < tb.link_proc_ptr[l + 1]; ++k) {
        c += ws.threads[tb.link_procs[k]] > 0 ? 1 : 0;
      }
      ws.ppbw[l] = per_proc_bw(c, more.bg[l], more.bw[l]);
    }
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
  if constexpr (Tb::kWide) {
    for (int i = lane + kSlots * kWarp; i < T; i += kWarp) {
      const float threads_leg = fmaxf(__int2float_rn(ws.threads[tb.proc_of_leg[i]]), 1.f);
      const float chunk = __fdiv_rn(
          __fmul_rn(__fmul_rn(more.active[i], more.keep[i]), ws.ppbw[tb.link_of_leg[i]]),
          threads_leg);
      ws.x[i] = fminf(more.remaining[i], chunk);
    }
  }
  __syncwarp();
  segment_sums(tb, ws, lane, L);
}

// One element's per-process and per-link sums out: processes past the last
// one in any list sum nothing.
template <class Tb, class Ws>
__device__ void write_sums(const Tb& tb, const Ws& ws, float* proc, float* link, size_t e,
                           int lane, int P, int L) {
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
    fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, LegRows{}, lane, T, L);
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

// One tick's outputs of element e: the slots' transfers, under wide tables
// those past them from ws.x, then the sums.
template <int kSlots, class Tb, class Ws>
__device__ void write_tick(const TickArgs& g, const Tb& tb, const Ws& ws,
                           const float (&xf)[kSlots], size_t e, int lane) {
  const size_t leg0 = e * g.T;
  #pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int i = lane + j * kWarp;
    if (i < g.T) g.xfer[leg0 + i] = xf[j];
  }
  if constexpr (Tb::kWide) {
    for (int i = lane + kSlots * kWarp; i < g.T; i += kWarp) g.xfer[leg0 + i] = ws.x[i];
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
  fair_share(tb, ws, av, keep, rem, xf, bgv, bwv, LegRows{}, lane, T, L);
  write_tick(g, tb, ws, xf, e, lane);
}

// bank_tick_kernel on wide tables: kMaxSlots slots a lane, the legs past
// them and every link read from device memory.
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
  float av[kMaxSlots], keep[kMaxSlots], rem[kMaxSlots], xf[kMaxSlots];
  load_tick_legs(g, live, lane, e * T, keep_row, av, keep, rem, xf);
  const WideTables tb = stage_wide_tables(smem, g.tables, s, T, P, L);
  if (!live) return;
  WideScratch ws = wide_scratch(smem, warp, T, P, L);
  const LegRows more{g.active + e * T, keep_row, g.remaining + e * T, g.bg + e * L,
                     g.bw + (size_t)s * L};
  fair_share(tb, ws, av, keep, rem, xf, 0.f, 0.f, more, lane, T, L);
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

// bank_sums_kernel on wide tables.
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
  WideScratch ws = wide_scratch(smem, warp, T, P, L);
  if (live) {
    for (int i = lane; i < T; i += kWarp) ws.x[i] = g.v[e * T + i];
  }
  const WideTables tb = stage_wide_tables(smem, g.tables, s, T, P, L);  // publishes ws.x too
  if (!live) return;
  segment_sums(tb, ws, lane, L);
  write_sums(tb, ws, g.proc, g.link, e, lane, P, L);
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

// Launches a wide kernel with its dynamic shared memory, raising the
// kernel's limit past the default 48 KB where it needs more.
template <class Args>
int wide_launch(void (*kernel)(Args), const Args& g, dim3 grid, int T, int P, int L,
                void* stream) {
  const size_t smem = wide_smem_bytes(T, P, L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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

// Limits of the tick and sums launches on wide tables (one campaign).
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
  if (!fits_bank(T, P, L) || bad_shape(S, R, T, P, L) || K < 1) {
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
    const int err = wide_launch(bank_tick_wide_kernel, g, grid, T, P, L, stream);
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
    const int err = wide_launch(bank_sums_wide_kernel, g, grid, T, P, L, stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
