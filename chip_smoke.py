"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile every CUDA source under ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (all at once) and load it; ptxas registers and spills by
   kernel, the bf16 tensor-core kernels' and the bank kernels' blocks an SM,
   the wide bank kernels' dynamic shared memory and blocks an SM at the
   long tail's widest bucket and the serving bench's widest slot bank;
2. kernels — each bank kernel against its plain PyTorch version on the
   card, on a 7-family bank (bank-wide and per-replica keep/mu/sigma), and
   their wide instances on a scale-3 bank (T 162, P 162): bitwise, since
   both take every sum in the order of the bank's segment lists (the one
   tick also within RTOL/ATOL of the one-hot matmul); the spec's tables,
   built from the host rows, equal to those built from the incidences on
   the card, the fused window bitwise on both; then the wide instances at
   each shape the main path gives them (the serving bench's widest slot
   bank and every wide bucket of the long-tail fleet as the bucketed
   dispatch runs it): one K=32 window, one tick and its sums, bitwise, with
   the fused kernel's instance by ``grid_tick.wide_occupancy``;
3. main    — ``Fleet.from_scenarios(n=1024).run(replicas=64)`` (65,536
   elements) in tick and leap mode, default and stochastic params, with the
   kernels' launch counts of each timed run (counts set to 0 just before
   it, read just after);
3b. bucketed — the same fleet compiled in 8 cost-packed buckets, the four
   runs each bitwise equal to phase main's with the same keys, with
   elements/s, windows, bucket pads and launches beside phase main's; then
   a long-tail fleet (256 scale-3 scenarios, 8 buckets), tick and leap,
   whose buckets past T 128 run the wide kernel instances;
3c. stepped — ``simulate_bank_stepped`` on the main fleet (tick,
   stochastic) bitwise equal to phase main's ``Fleet.run``, a checkpoint
   at half its windows through ``Fleet.save_checkpoint`` (under
   ``build/stepped_check``), and the run resumed from ``Fleet.load`` /
   ``Fleet.load_checkpoint`` bitwise; walls beside the one-shot run's;
3d. stream — ``Fleet.stream`` over the same 1,024 pairs in chunks of 256
   with ``prefetch=1``, each chunk bitwise equal to its standalone
   ``simulate_bank`` run under the stream's key schedule;
3e. sim_serve — the port's ``SimServer`` on the card: (a) parity, the
   synthetic workload of 16 requests x 4 replicas (rate 200/s, scale 1)
   under ``ServeConfig(slots=8, replicas=4)``, base params and theta
   (0.05, 2.0, 1.0), tick and leap, every served row bitwise the card's
   ``Fleet.run`` of its scenario at the served pads; (b) the reference
   benchmark's workload (``BENCH_serve.json``: 64 requests, 4 replicas,
   rate 200/s, scale 4, seed 0) open loop in tick mode, with requests/s,
   latency and queue-delay percentiles, rounds, banks, windows per rung,
   the admit / dispatch / sync / retire wall split, the seconds of bank
   creation before the rounds (each cold slot bank's warm-up), and the
   synchronizing CUDA calls of bank creation and of the ADMIT and DISPATCH
   phases (warnings under ``torch.cuda.set_sync_debug_mode("warn")``, by
   source line); (c) 256 requests x 64 replicas at t = 0 under
   ``ServeConfig(slots=64, replicas=64)``, every row bitwise a warm batch
   ``Fleet.run`` of the same pairs and keys on the overlapping extent,
   scenario-replicas/s beside the batch run's elements/s, and the seconds
   of bank creation;
4. parity  — bitwise window invariance (K=1 vs K=64) on 64 scenarios x 4
   replicas; the card's normals bitwise against the CPU path's (200,000
   keys x 11); the card's ``Fleet.run`` against the CPU path on a small
   bank, default and stochastic (``bg_mu=2, bg_sigma=1.5``) params; the
   calibration test fixture's run (theta (0.05, 40, 20), 2 replicas, key
   42, leap) with ConPr exactly 0 at the same legs on both, Eq.-1 fits
   within rtol 1e-4; a small bucketed scale-3 fleet (one bucket past T
   128), card against CPU path, bitwise, tick and leap;
5. profile — device time by kernel of one tick and one leap main-path run
   under ``torch.profiler``, and the device's busy share;
6. timing  — each bank kernel and its plain version at the main path's
   shapes, and each wide instance at the long-tail fleet's widest bucket:
   the outputs held bitwise against each other, the times taken as
   profiler device time and with CUDA events, beside the least time the
   card could take;
7. calibrate — the SELU-MLP kernel against its plain version at the
   calibration path's shapes (forward and backward; N = 8,192, 4,096, the
   Section-5 chains' N = 4 and a ragged 37; each bitwise equal),
   timed by CUDA events and by profiler device time beside its bound and
   its bound without FMA; then the amortized calibration path at full width,
   ``Fleet.from_scenarios(n=1024).calibrate(x_true, key,
   CalibrationConfig(), amortized=True)`` (65,536 presimulated tuples, 30
   epochs of the 4x128 classifier at batch 4,096), ``theta_star_all`` over
   every scenario (8,192 chains) and ``Fleet.validate``, with each stage's
   seconds and kernel launches (counts set to 0 just before a stage, read
   just after); the device time per MCMC and training step under
   ``torch.profiler``; and a 200-step chain on the card against the CPU
   path;
8. kernels (per campaign) — the per-campaign tick (the bank tick at S = 1,
   its wide instance past the bank limits) against its plain versions
   (``ref.grid_tick_indexed`` bitwise, ``ref.grid_tick`` within RTOL/ATOL)
   and the per-campaign sums launch on its transfers (``ref.bank_sums`` at
   S = 1, bitwise) on the paper's Section-5 campaign (T=106, P=11, L=1) at
   B = 7 and B = 2,048, shared and per-row keep, finite and infinite
   ``remaining``, and on a 700-leg campaign (P=90, L=40);
9. campaign — ``simulate_batch`` of the Section-5 campaign at B = 2,048,
   tick and leap, default and stochastic background load, with sims/s and
   launches per run (in a leap run one sums launch an event step, one per
   tick launch); device time by kernel of a stochastic tick (100 ticks) and
   leap run (3,000 ticks) under ``torch.profiler``; window invariance (K=1
   vs K=64 on 64 simulations, the tick run cut at 2,000 ticks, bitwise);
   card vs CPU path, bitwise (4 simulations, the tick run cut at 500
   ticks); the tick's and the sums launch's device time at the main shape
   (``torch.profiler``) beside their bounds,
   the sums beside the one-hot matmul they replace;
10. section5 — ``repro_torch.launch.calibrate``'s ``main`` at its defaults
   (8,192 presimulated tuples x 4 replicates, 120 epochs, 4 x 8,000 MCMC
   steps, 64 validation runs), seconds and kernel launches per stage,
   finite theta*, MAP and R-hat;
11. optimize — ``optimize_profiles`` (population 32, 12 generations) on the
   congested grid of the repo's scheduler test: no worse than all-remote,
   the same history as the CPU path;
12. llm_kernels — the flash-attention, decode-attention and mLSTM kernels
   against their plain versions on small ragged cases (float32 and bf16;
   flash also at an odd head dim and on pointers off 16 bytes; decode also
   on a 2,112-slot cache with ragged lengths, every decode call repeated
   and held bitwise to the first) and at hymba-1.5b's serving shapes
   (bf16), then timed beside their bounds, their plain versions and,
   where one PyTorch call computes the same function, that call (CUDA
   events; decode, faster than its host call, by device time under
   ``torch.profiler`` on an L2-cold cache; bf16 flash runs the tensor-core
   forward, float32 the CUDA-core one; decode reports its splits of the
   cache and blocks; bf16 SSD runs the tensor-core mLSTM kernel, held also
   to its rounding model ``ref.mlstm_chunk_tc``, with its blocks, waves,
   registers and shared memory); then head dim 128: the flash forward's
   width-128 instances on the same ragged cases at D 128, 96 and 77 and on
   pointers off 16 bytes (float32 and bf16), decode attention at D 128 with
   GQA groups 1, 2, 4 and 5 on ragged lengths and on qwen2-moe-a2.7b's
   2,112-slot cache; both timed (CUDA events and device time) at
   qwen2-moe-a2.7b's shapes (16 / 16 heads) and the dense D = 128 configs'
   (qwen2.5-14b 40 / 8, minitron-8b 32 / 8, gemma3-27b 32 / 16 at its
   1,024 window) beside bound, plain and SDPA; then the flash forward at
   seamless-m4t-large-v2's shapes without a mask (its encoder, 1,024 frames
   over 1,024; its cross-attention, 2,048 prompt positions over 1,024
   frames, and in decode one query row over them) and internvl2-2b's causal
   prefill (16 / 8 heads of 128), bf16 and the same values in float32, each
   timed beside bound, plain and SDPA on the same call;
13. llm_serve — hymba-1.5b at full width (bf16, random weights from a seed):
   8 prompts of 2,048 tokens through ``make_prefill_step``, then 64 greedy
   ``make_serve_step`` steps, with tokens/s, launches per run, peak memory
   and device time by kernel under ``torch.profiler``; decode against
   prefill on the card, and the card against the CPU path in float32 (one
   pattern unit of 8 layers, 2 x 1,280 tokens, 8 decode steps);
13b. llm_xlstm — xlstm-350m's serving path past Dk 64: the tensor-core
   pair (``mlstm_wide_state_kernel`` then ``mlstm_wide_out_kernel``, bf16
   with chunks a multiple of 16, either flag) against its rounding model
   ``ref.mlstm_chunk_tc`` and, with the Dk-tiled kernel
   (``mlstm_chunk_tiled_kernel``: float32, and bf16 off the multiple of
   16), against ``ref.mlstm_chunk_chunked`` at Dk 80, 100, 128 and 512
   (both flags, S off the chunk, element staging at Dk 100 / Dv 33), each
   call's launches held to its route; then at the prefill's shape (B 8, S
   2,048, H 4, Dk = Dv = 512): the pair in bf16 timed by CUDA events and
   each kernel's device time beside its own bound and the cell's, the
   float32 floor and the plain version, with registers, spills, shared
   memory, blocks an SM, waves and its SASS's HMMA count; the tiled kernel
   likewise in float32; a float32 xLSTM of one mLSTM and one sLSTM layer at
   full width on the card against the CPU path (2 x 256 tokens, 8 decode
   steps; logits and every cache leaf; one tiled launch); xlstm-350m at
   full width (bf16, random weights from a seed): 8 x 2,048 prompt tokens
   and 64 greedy decode steps, tokens/s, peak memory, launches per run (21
   of each of the pair a prefill, 0 a decode step, no attention), the
   sLSTM loops' share of a prefill's wall, device busy share of a prefill
   and a decode step under ``torch.profiler``; decode against prefill:
   layer by layer on the same inputs in float32 (held to its limit), end
   to end in float32 and bf16 (reported, bf16 as a share of its limit,
   beside the float32 prefill's response to a 1e-7 perturbation of the
   embedding);
13c. llm_moe — qwen2-moe-a2.7b's serving path: one MoE layer at full
   width in float32, the card against the CPU path (2 x 128 tokens, 4
   decode steps, logits and the KV cache); the model at full width (bf16,
   14.3e9 parameters, random weights from a seed): 8 x 2,048 prompt tokens
   and 64 greedy decode steps, tokens/s, peak memory, launches per run (24
   flash forward a prefill, 24 decode attention a step, nothing else), the
   (token, choice) pairs the prefill's MoE dropped per layer, device time
   by kernel of a prefill and a decode step; decode against prefill layer
   by layer in float32 on the same inputs, held where the prefill dropped
   none of the last token's pairs (the rest counted and reported), and end
   to end in bf16 (reported against its limit); then both again with room
   in every expert's queue (capacity factor E / k), where nothing drops and
   every layer is held;
13d. llm_encdec — seamless-m4t-large-v2 (24 encoder layers over 1,024
   speech frames, 24 decoder layers with cross-attention) and internvl2-2b
   (256 image embeddings in front of the prompt): each at full width and 2
   decoder (and encoder) layers in float32 on the card against the CPU path
   (2 x 320 tokens, 4 decode steps; logits and every cache tensor,
   ``cross_kv`` too); then at full width and depth in bf16 (random weights
   and frontend inputs from a seed): 8 x 2,048 prompt tokens and 64 greedy
   decode steps, tokens/s, peak memory, launches per run (seamless: 72
   flash a prefill, 24 flash at one query row and 24 decode attention a
   step; internvl2: 24 flash a prefill, 24 decode a step), device time of
   a prefill and a decode step; decode against prefill layer by layer in
   float32 (held) and end to end in bf16 (reported against its limit);
14. llm_train_kernels — the flash-attention backward kernels (dq, dk/dv)
   against their plain version on ragged cases (GQA groups of 1, 2 and 8, a
   window, ``q_offset``, dead rows beside live ones, an odd head dim,
   pointers off 16 bytes; float32 and bf16) and at TinyLlama-1.1B's
   training shapes (B 8, S 2,048, 32 / 4 heads of 64, causal; three seeds),
   bf16 rows (dq and dk/dv on the tensor cores) held to a rounding model
   of plain values, their shares of it and of the old limit reported; the
   forward there too; then each timed with CUDA events beside its bound,
   the plain version and ``F.scaled_dot_product_attention``'s forward and
   backward; then the backward at Hymba-1.5B's attention training shapes
   (25 / 5 heads, causal and the 1,024 window) to the same limits; the SSD
   / mLSTM backward (``ops.MlstmChunk``: torch ops, no TPU kernel) on the
   card against the CPU path (both flags, S 100 and 300, two widths,
   float32 and bf16), and timed at Hymba's SSD training shapes beside the
   forward kernel, with its launches and bound;
15. llm_train — TinyLlama-1.1B and Hymba-1.5B at full width (bf16, random
   weights from a seed): ``make_train_step`` with the trainer's AdamW on 8
   x 2,048 tokens a step from the port's ``TokenStream``, 1 warm-up and 5
   (TinyLlama) or 3 (Hymba) timed steps, with tokens/s, losses, grad norms,
   peak memory, launches per step held to their counts, and one step under
   ``torch.profiler`` (Hymba's SSD backward range and its share); one
   float32 step of 2 layers of each (qwen2-moe's of 1) on the card against
   the CPU path; the ``Trainer``'s restart continuity on the card at both
   smoke configs (6 steps straight against 3, a restore, 3 more).

Then the ``kernels`` line, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import CalibrationConfig, Fleet, simulate_bank  # noqa: E402
from repro_torch.convert import classifier_from_reference, classifier_to_reference  # noqa: E402
from repro_torch.core import calibration, classifier, engine, mcmc, prng  # noqa: E402
from repro_torch.core import scheduler, topology, workload  # noqa: E402
from repro_torch.core.scenarios import build_bank, sample_scenarios  # noqa: E402
from repro_torch.kernels import _build, grid_tick, ops, ref, selu_mlp  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention, mlstm_chunk  # noqa: E402
from repro_torch.launch import calibrate as calibrate_launcher  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.serve import ServeConfig, SimRequest, SimServer, synthetic_workload  # noqa: E402
from repro_torch.serve import cache as serve_cache  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as llm  # noqa: E402
from repro_torch.models import transformer as llm_stack  # noqa: E402
from repro_torch.models.blocks import MoE, init_attention_cache  # noqa: E402
from repro_torch.models.common import cross_entropy_loss, rms_norm  # noqa: E402
from repro_torch.models.config import BlockKind  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.train import trainer as llm_trainer  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
# kernel vs a plain version whose sums run in another order (a one-hot
# matmul, or the CPU path's regression solve): integer and bool fields
# equal, float fields within these
RTOL, ATOL = 1e-5, 1e-4

N_SCEN, N_REP = 1024, 64
BANK_KERNELS = ("grid_tick_bank_fused", "grid_tick_bank", "grid_tick_bank_sums")
# the bank kernels' wide instances (tables in dynamic shared memory), past
# T 128, P 128 or L 32 a scenario
WIDE_KERNELS = ("grid_tick_bank_fused_wide", "grid_tick_bank_wide", "grid_tick_bank_sums_wide")
MAIN_PARAMS = (("default", {}), ("stochastic", dict(bg_mu=2.0, bg_sigma=1.0)))
# the bucketed cells: the main fleet in 8 cost-packed buckets, and a
# long-tail fleet (scale 3) whose widest buckets pass the narrow kernels
N_BUCKETS = 8
LONG_TAIL = dict(n=256, seed=0, scale=3.0, n_buckets=N_BUCKETS)
STREAM_CHUNK = 256
# phase sim_serve: the parity workload, the reference benchmark's workload
# (BENCH_serve.json) and the fleet-width one
SERVE_THETA = (0.05, 2.0, 1.0)
SERVE_PARITY = dict(n=16, rate=200.0, scale=1.0, replicas=4, slots=8)
SERVE_BENCH = dict(n=64, rate=200.0, scale=4.0, replicas=4, slots=8)
SERVE_WIDE = dict(n=256, scale=1.0, replicas=64, slots=64)
# the paper's Section-5 campaign as the calibration launcher compiles it
# (T=106 legs, P=11 processes, L=1 link), the batch of one presimulation
# chunk (512 thetas x 4 replicates) and the launcher's ground truth
SECTION5_MAX_TICKS, CAMPAIGN_B = 30_000, 2048
THETA_SECTION5 = (0.02, 36.9, 14.4)
# the calibration path's classifier: 3 theta + 3 x + 9 context features in,
# 4 hidden SELU layers of 128, one logit out
MLP_IN, MLP_HIDDEN, MLP_DEPTH = 15, 128, 4
THETA_TRUE = (0.05, 40.0, 20.0)


# the process's start: every JSON line carries its seconds since then ("t")
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T_START, **fields}), flush=True)


@functools.lru_cache(maxsize=None)
def smi() -> str:
    """The card's name and power limit (``nvidia-smi``), read once a run."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, exact: bool, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance
    (or on any difference when ``exact``)."""
    if got.dtype in (torch.bool, torch.int32, torch.int64) or exact:
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} elements differ")
        return 0.0
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * want.double().abs()
    if not bool(torch.all(err <= lim)):
        raise AssertionError(f"{name}: max abs err {float(err.max())} past tolerance")
    return float(err.max())


def window_inputs(bank, R, K, dev, per_replica: bool, seed: int = 0):
    """A mid-run carry of ``bank`` x ``R`` replicas (a few plain windows in)
    plus the constants and ``K`` noise rows of the next window."""
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    S, T, L = bank.n_scenarios, bank.pad_legs, bank.pad_links
    g = torch.Generator(device="cpu").manual_seed(seed)
    keep, mu, sigma = p.keep_frac, p.bg_mu[:, None], p.bg_sigma[:, None]
    if per_replica:
        scale = lambda: (0.9 + 0.1 * torch.rand((S, R, 1), generator=g)).to(dev)
        keep = keep[:, None] * scale()
        mu, sigma = mu * scale(), sigma * scale()
    consts = (
        spec.release, spec.dep, spec.bg_period, spec.max_ticks, keep,
        spec.bandwidth, spec.leg_proc, spec.proc_link, spec.leg_link,
    )
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64, device=dev))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    for _ in range(3):
        warm = torch.randn((K, S, R, L), generator=g).to(dev)
        state = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=warm,
                                          tables=spec.bank_tables)
        state = (state[0], torch.zeros_like(state[1])) + tuple(state[2:])
    noise = torch.randn((K, S, R, L), generator=g).to(dev)
    return state, mu, sigma, consts, noise, spec.bank_tables


def check_bank_tick(label, active, remaining, keep, bg, consts, tables) -> dict:
    """The one-tick kernel against its plain version: bitwise against
    ``ref.grid_tick_bank_indexed`` (the kernel's sum order), and within
    RTOL/ATOL against the one-hot matmul of ``ref.grid_tick``; then the sums
    kernel on the tick's transfers, bitwise against ``ref.bank_sums``. Max
    abs errors against the former (0) by output."""
    lp, pl, ll = consts[6], consts[7], consts[8]
    got = ops.grid_tick_bank(active, remaining, keep, bg, consts[5], lp, pl, ll, tables=tables)
    want = ref.grid_tick_bank_indexed(active, remaining, keep, bg, consts[5], lp, pl, tables)
    keep3 = keep if keep.dim() == 3 else keep[:, None]
    dense = ref.grid_tick(active, remaining, keep3, bg, consts[5][:, None],
                          lp[:, None], pl[:, None], ll[:, None])
    errs = {}
    for n, g_, w_, d_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want, dense):
        errs[n] = compare(f"tick {label} {n}", g_, w_, exact=True)
        compare(f"tick {label} {n} vs one-hot matmul", g_, d_, exact=False)
    for n, g_, w_ in zip(("proc", "link"), ops.grid_tick_bank_sums(want[0], tables), want[1:]):
        errs[f"sums_{n}"] = compare(f"sums {label} {n}", g_, w_, exact=True)
    return errs


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build()
    limits = grid_tick.limits()
    occupancy = flash_attention.mma_occupancy()
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         built=sorted(built), max_legs_procs_links=list(limits),
         selu_mlp_max_hidden_in_out_depth=list(selu_mlp.limits()), card=smi(),
         ptxas={k: ptxas_by_kernel(v) for k, v in _build.build_logs.items()},
         flash_mma_blocks_per_sm=occupancy)
    # the bank kernels' registers, spills and blocks an SM on their own line
    bank_ptxas = {k: v for k, v in ptxas_by_kernel(_build.build_logs.get("grid_tick", "")).items()
                  if "bank_" in k}
    emit("build", kernel="bank_fused_kernel, bank_tick_kernel", ptxas=bank_ptxas,
         blocks_per_sm=grid_tick.bank_occupancy())
    # the wide instances' registers and spills, and their dynamic shared
    # memory and blocks an SM at the long tail's widest bucket and the
    # serving bench's widest slot bank
    wide_ptxas = {k: v for k, v in bank_ptxas.items() if "_wide_" in k}
    emit("build", kernel="bank_fused_wide_kernel, bank_tick_wide_kernel, bank_sums_wide_kernel",
         ptxas=wide_ptxas, occupancy={f"{t}x{p_}x{l}": grid_tick.wide_occupancy(t, p_, l)
                                      for t, p_, l in ((196, 196, 2), (256, 256, 8))})
    # the bf16 forward's registers, spills and blocks an SM at both widths
    fwd_ptxas = {k: v for k, v in ptxas_by_kernel(_build.build_logs.get("flash_attention", "")).items()
                 if k.startswith("flash_fwd")}
    emit("build", kernel="flash_fwd_mma_kernel, flash_fwd_kernel", ptxas=fwd_ptxas,
         blocks_per_sm={w: occupancy[k] for w, k in (("64", "flash_attention_fwd"),
                                                     ("128", "flash_attention_fwd_d128"))})
    # the backward's kernels (dq and dk/dv, bf16 and float32): registers,
    # spills and the bf16 kernels' blocks an SM at both widths
    flash_ptxas = ptxas_by_kernel(_build.build_logs.get("flash_attention", ""))
    for part in ("dq", "dkv"):
        ptxas = {k: v for k, v in flash_ptxas.items() if k.startswith(f"flash_bwd_{part}_")}
        emit("build", kernel=f"flash_bwd_{part}_mma_kernel, flash_bwd_{part}_kernel", ptxas=ptxas,
             blocks_per_sm={w: occupancy[f"flash_attention_bwd_{part}{s_}"]
                            for w, s_ in (("64", ""), ("128", "_d128"))})
    return {"seconds": time.perf_counter() - t0}


def ptxas_by_kernel(log: str) -> dict:
    """``-Xptxas -v`` lines by kernel: its registers and shared memory
    ("Used ...") and its stack and spills."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*?([A-Za-z_]+kernel)(I\w*?EE)?", ln)
        if m:
            name = m.group(1) + (m.group(2) or "")
        elif name and ("spill" in ln or "Used" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def sass_counts(source: str) -> dict:
    """Instructions by kernel of a built source's SASS (``cuobjdump -sass``):
    all, tensor-core products (``HMMA``, ``HGMMA``) and local-memory
    accesses; empty where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(source))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : \S*?([A-Za-z_]+kernel)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {"instructions": 0, "HMMA": 0, "HGMMA": 0, "local": 0})
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            row = out[name]
            row["instructions"] += 1
            for op in ("HMMA", "HGMMA"):
                row[op] += bool(re.search(rf"\b{op}\.", ln))
            row["local"] += bool(re.search(r"\b(LDL|STL)\b", ln))
    return out


def phase_kernels(dev) -> dict:
    """The bank kernels against their plain versions on a 64-scenario bank,
    and their wide instances on a 64-scenario scale-3 bank (T 162, P 162):
    the fused window bitwise on every carry field, the one tick bitwise on
    its three outputs (``remaining`` finite, and ``inf`` as the leap scan
    calls it), and the sums kernel bitwise on the tick's transfers; then the
    wide instances at :func:`wide_main_path_shapes` (one K=32 window of
    :func:`first_window`, one tick of :func:`tick_inputs` and its sums)."""
    R, K = 8, 16
    errs = {k: 0.0 for k in BANK_KERNELS + WIDE_KERNELS}
    for names, bank in ((BANK_KERNELS, build_bank(n=64, seed=0)),
                        (WIDE_KERNELS, build_bank(n=64, seed=0, scale=3.0))):
        fused, tick, sums = names
        assert grid_tick._wide(bank.pad_legs, bank.pad_procs, bank.pad_links) == (
            names == WIDE_KERNELS)
        for per_replica in (False, True):
            state, mu, sigma, consts, noise, tables = window_inputs(bank, R, K, dev, per_replica)
            want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                             tables=tables)
            got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=K, noise=noise,
                                           tables=tables)
            fields = {}
            for name, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
                fields[name] = compare(f"{fused} {name}", g_, w_, exact=True)
            errs[fused] = max(errs[fused], *fields.values())
            emit("kernels", kernel=fused, per_replica=per_replica, bitwise=True,
                 S=bank.n_scenarios, R=R, K=K, pads=[bank.pad_legs, bank.pad_procs, bank.pad_links],
                 max_abs_err=fields, alive_steps=int(got[1].sum()))
            if not per_replica:
                check_card_built_tables(fused, state, mu, sigma, consts, noise, tables, want, K)

            # one tick at the same state: a random active set over unfinished legs
            g = torch.Generator(device="cpu").manual_seed(1)
            done, remaining, bg = state[3], state[2], state[9]
            active = ((torch.rand(done.shape, generator=g).to(dev) < 0.7) & ~done).float()
            for label, rem in (("remaining", remaining),
                               ("inf", torch.full_like(remaining, float("inf")))):
                fields = check_bank_tick(label, active, rem, consts[4], bg, consts, tables)
                errs[tick] = max(errs[tick], fields["xfer"], fields["proc_xfer"],
                                 fields["link_xfer"])
                errs[sums] = max(errs[sums], fields["sums_proc"], fields["sums_link"])
                emit("kernels", kernel=tick, per_replica=per_replica, remaining=label,
                     bitwise=True, S=bank.n_scenarios, R=R, max_abs_err=fields)
    fused, tick, sums = WIDE_KERNELS
    for label, spec, p, R_ in wide_main_path_shapes(dev):
        S, T = spec.size_mb.shape
        P, L = spec.leg_proc.shape[-1], spec.bandwidth.shape[-1]
        state, noise, mu, sigma, consts = first_window(spec, p, R_, dev)
        tables = spec.bank_tables
        want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                         tables=tables)
        got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=32, noise=noise,
                                       tables=tables)
        fields = {name: compare(f"{fused} {label} {name}", g_, w_, exact=True)
                  for name, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want)}
        errs[fused] = max(errs[fused], *fields.values())
        occ = grid_tick.wide_occupancy(T, P, L)
        emit("kernels", kernel=fused, case=label, bitwise=True, S=S, R=R_, K=32, pads=[T, P, L],
             instance=f"<{occ['fused_slots']}, {occ['fused_link_slots']}>",
             max_abs_err=fields, alive_steps=int(got[1].sum()))
        active, remaining, keep, bg = tick_inputs(spec, p, R_, dev)[:4]
        fields = check_bank_tick(label, active, remaining, keep, bg, consts, tables)
        errs[tick] = max(errs[tick], fields["xfer"], fields["proc_xfer"], fields["link_xfer"])
        errs[sums] = max(errs[sums], fields["sums_proc"], fields["sums_link"])
        emit("kernels", kernel=tick, case=label, remaining="inf", bitwise=True, S=S, R=R_,
             max_abs_err=fields)
    torch.cuda.synchronize()
    return errs


def check_card_built_tables(name, state, mu, sigma, consts, noise, tables, want, K) -> None:
    """The spec's tables, built from the bank's host rows, against the
    tables ``ref.bank_index_tables`` builds from the incidences on the card:
    equal field for field and plan step for plan step, and the fused
    window on the card-built ones bitwise the plain window too."""
    card = ref.bank_index_tables(*consts[6:9])
    for field, h, c in zip(tables._fields, tables, card):
        if isinstance(h, ref.SegmentPlan):
            assert h.steps == c.steps and h.n_segments == c.n_segments, field
            for f in ("src", "dst", "pos"):
                same(f"tables {field}.{f}", getattr(h, f), getattr(c, f))
        else:
            same(f"tables {field}", h, c)
    got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=K, noise=noise, tables=card)
    for field, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
        compare(f"{name} on card-built tables {field}", g_, w_, exact=True)
    emit("kernels", kernel=name, check="host-built tables equal card-built ones; the window "
         "on either bitwise the plain window", equal=True, bitwise=True)


def counted_run(fleet, params, leap: bool, warm: bool = True):
    """One ``Fleet.run`` at ``N_REP`` replicas (after an uncounted warm-up
    when ``warm``), its counts set to 0 just before it and read just after:
    ``(result, wall, windows, buckets, launches)``."""
    if warm:
        fleet.run(params, replicas=N_REP, leap=leap)
    torch.cuda.synchronize()
    engine.STATS["windows"] = engine.STATS["buckets"] = 0
    grid_tick.reset_launches()
    t0 = time.perf_counter()
    res = fleet.run(params, replicas=N_REP, leap=leap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, engine.STATS["windows"], engine.STATS["buckets"], dict(grid_tick.LAUNCHES)


def check_result(res, fleet, dev) -> float:
    """Shapes, finite values and non-negative durations of a fleet run;
    the share of its valid legs that finished."""
    shape = (fleet.n_scenarios, N_REP, fleet.pads[0])
    for f in ("transfer_time", "conth_mb", "conpr_mb", "start_tick"):
        x = getattr(res, f)
        assert tuple(x.shape) == shape, (f, tuple(x.shape))
        assert bool(torch.isfinite(x).all()), f"{f} not finite"
    assert bool((res.transfer_time >= 0).all()), "negative transfer_time"
    valid = torch.as_tensor(fleet.bank.leg_valid, device=dev)[:, None, :]
    return float((res.done & valid).sum() / valid.expand_as(res.done).sum())


def phase_main(dev) -> dict:
    """The four timed runs (tick/leap x default/stochastic), each after an
    uncounted warm-up. ``launches`` sums the four runs' counts; the results
    are kept for the bucketed and stepped phases."""
    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, device=dev)
    runs, results = [], {}
    for leap in (False, True):
        for label, kw in MAIN_PARAMS:
            res, wall, windows, _, launches = counted_run(fleet, fleet.params(**kw), leap)
            run = dict(
                mode="leap" if leap else "tick", params=label, wall_s=wall,
                elements=N_SCEN * N_REP, elements_per_s=N_SCEN * N_REP / wall,
                windows=windows, realized_ticks=int(res.ticks.max()),
                done_share=check_result(res, fleet, dev), launches=launches,
            )
            emit("main", **run)
            runs.append(run)
            results[(run["mode"], label)] = res
    launches = {k: sum(r["launches"][k] for r in runs) for k in BANK_KERNELS}
    by_run = {k: {f"{r['mode']}_{r['params']}": r["launches"][k] for r in runs}
              for k in BANK_KERNELS}
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    emit("main", pads=list(fleet.pads), launches=launches, launches_by_run=by_run)
    return {"launches": launches, "by_run": by_run, "runs": runs, "results": results}


def phase_bucketed(dev, main_run: dict) -> dict:
    """The main fleet in ``N_BUCKETS`` cost-packed buckets (tick costs for
    the tick fleet, leap costs for the leap one), each run bitwise equal to
    phase main's run with the same keys and reported beside it; then the
    long-tail fleet, whose widest buckets run the wide kernel instances.
    In place of a warm-up run (phase main has warmed the kernels), each
    bucket's spec is uploaded before the timed runs: a run is paced by its
    windows on the host, so a warm-up would cost as much as the run."""
    main_by = {(r["mode"], r["params"]): r for r in main_run["runs"]}
    by_run = {}
    for leap in (False, True):
        mode = "leap" if leap else "tick"
        fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, n_buckets=N_BUCKETS, leap=leap,
                                     device=dev)
        for b in fleet.bank.buckets:
            engine.bank_spec(b.bank, dev)
        for label, kw in MAIN_PARAMS:
            res, wall, windows, buckets, launches = counted_run(fleet, fleet.params(**kw), leap,
                                                                warm=False)
            want = main_run["results"][(mode, label)]
            for f in res._fields:
                compare(f"bucketed vs main {mode} {label} {f}", getattr(res, f), getattr(want, f),
                        exact=True)
            assert buckets == fleet.n_buckets, (buckets, fleet.n_buckets)
            m = main_by[(mode, label)]
            by_run[f"bucketed_{mode}_{label}"] = launches
            emit("bucketed", fleet="main", mode=mode, params=label, bitwise_vs_main=True,
                 wall_s=wall, elements_per_s=N_SCEN * N_REP / wall, windows=windows,
                 buckets=buckets, launches={k: v for k, v in launches.items() if v},
                 main_wall_s=m["wall_s"], main_elements_per_s=m["elements_per_s"],
                 main_windows=m["windows"],
                 main_launches={k: v for k, v in m["launches"].items() if v},
                 bucket_pads=fleet.bucket_pad_floors,
                 bucket_scenarios=list(fleet.bucket_scenario_counts),
                 done_share=check_result(res, fleet, dev))
    limit = grid_tick.limits()
    for leap in (False, True):
        mode = "leap" if leap else "tick"
        fleet = Fleet.from_scenarios(**LONG_TAIL, leap=leap, device=dev)
        pads = fleet.bucket_pad_floors
        wide_buckets = [p for p in pads if any(x > m for x, m in zip(p, limit))]
        assert any(p[0] > 128 for p in pads), pads
        res, wall, windows, buckets, launches = counted_run(fleet, fleet.params(), leap,
                                                            warm=False)
        wide = ("grid_tick_bank_fused_wide",) if not leap else WIDE_KERNELS[1:]
        for k in wide:
            assert launches[k] > 0, f"{k} was not launched on the long-tail fleet"
        by_run[f"long_tail_{mode}"] = launches
        emit("bucketed", fleet="long-tail", mode=mode, params="default", first_run=True,
             wall_s=wall, elements_per_s=fleet.n_scenarios * N_REP / wall, windows=windows,
             buckets=buckets, launches={k: v for k, v in launches.items() if v},
             bucket_pads=pads, wide_buckets=wide_buckets,
             bucket_scenarios=list(fleet.bucket_scenario_counts),
             realized_ticks=int(res.ticks.max()), done_share=check_result(res, fleet, dev))
    return {"by_run": by_run}


def phase_stepped(dev, main_run: dict) -> dict:
    """``simulate_bank_stepped`` on the main fleet, tick stochastic, with a
    checkpoint at half phase main's windows written by
    ``Fleet.save_checkpoint``; the one-shot stepped run and the run resumed
    from ``Fleet.load`` / ``Fleet.load_checkpoint`` of that directory, each
    bitwise equal to phase main's ``Fleet.run``."""
    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, device=dev)
    kw = dict(MAIN_PARAMS)["stochastic"]
    params = fleet.params(**kw)
    keys = prng.split(prng.PRNGKey(0, dev), N_SCEN * N_REP).reshape(N_SCEN, N_REP, 2)
    want = main_run["results"][("tick", "stochastic")]
    main = {(r["mode"], r["params"]): r for r in main_run["runs"]}[("tick", "stochastic")]
    half = max(1, main["windows"] // 2)
    path = os.path.join(ROOT, "build", "stepped_check")
    saved = {}

    def on_checkpoint(ck):
        if not saved:
            t = time.perf_counter()
            fleet.save_checkpoint(path, ck)
            saved.update(windows_done=ck.windows_done, save_s=time.perf_counter() - t)

    torch.cuda.synchronize()
    engine.STATS["windows"] = 0
    grid_tick.reset_launches()
    t0 = time.perf_counter()
    got = engine.simulate_bank_stepped(fleet.bank, params, keys, device=dev,
                                       checkpoint_every=half, on_checkpoint=on_checkpoint)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    windows, launches = engine.STATS["windows"], dict(grid_tick.LAUNCHES)
    for f in got._fields:
        compare(f"stepped vs Fleet.run {f}", getattr(got, f), getattr(want, f), exact=True)
    loaded, ck = Fleet.load(path, device=dev), Fleet.load_checkpoint(path)
    torch.cuda.synchronize()
    grid_tick.reset_launches()
    t0 = time.perf_counter()
    resumed = engine.simulate_bank_stepped(loaded.bank, loaded.params(**kw), keys, device=dev,
                                           resume=ck)
    torch.cuda.synchronize()
    resumed_wall = time.perf_counter() - t0
    resumed_launches = dict(grid_tick.LAUNCHES)
    for f in resumed._fields:
        compare(f"resumed vs Fleet.run {f}", getattr(resumed, f), getattr(want, f), exact=True)
    assert launches["grid_tick_bank_fused"] > 0 and resumed_launches["grid_tick_bank_fused"] > 0
    emit("stepped", mode="tick", params="stochastic", bitwise_vs_run=True, wall_s=wall,
         wall_without_checkpoint_save_s=wall - saved["save_s"], checkpoint_save_s=saved["save_s"],
         one_shot_run_wall_s=main["wall_s"], windows=windows, run_windows=main["windows"],
         checkpoint_windows_done=saved["windows_done"], resumed_bitwise=True,
         resumed_wall_s=resumed_wall, launches={k: v for k, v in launches.items() if v},
         resumed_launches={k: v for k, v in resumed_launches.items() if v})
    return {"by_run": {"stepped": launches, "stepped_resumed": resumed_launches}}


def phase_stream(dev) -> dict:
    """``Fleet.stream`` of the main fleet's 1,024 pairs in chunks of
    ``STREAM_CHUNK`` with ``prefetch=1`` (tick, each chunk's own params),
    each chunk bitwise equal to its standalone ``simulate_bank`` run under
    the stream's key schedule."""
    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, device=dev)
    pairs = sample_scenarios(None, N_SCEN, 0)
    torch.cuda.synchronize()
    grid_tick.reset_launches()
    t0 = time.perf_counter()
    chunks = list(fleet.stream(iter(pairs), chunk=STREAM_CHUNK, replicas=N_REP, prefetch=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(grid_tick.LAUNCHES)
    key = prng.PRNGKey(0, dev)
    for i, c in enumerate(chunks):
        key, sub = prng.split(key, 2)
        keys = prng.split(sub, STREAM_CHUNK * N_REP).reshape(STREAM_CHUNK, N_REP, 2)
        want = simulate_bank(c.bank, engine.make_bank_params(c.bank, device=dev), keys,
                             device=dev)
        for f in want._fields:
            compare(f"stream chunk {i} {f}", getattr(c.result, f), getattr(want, f), exact=True)
    assert len(chunks) == N_SCEN // STREAM_CHUNK
    assert launches["grid_tick_bank_fused"] > 0
    emit("stream", mode="tick", params="default", chunks=len(chunks), chunk=STREAM_CHUNK,
         prefetch=1, bitwise_vs_standalone=True, wall_s=wall,
         elements_per_s=N_SCEN * N_REP / wall, launches={k: v for k, v in launches.items() if v})
    return {"by_run": {"stream": launches}}


def same(name, got, want) -> None:
    """``got`` bitwise ``want``: same shape, dtype and bits."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, tuple(got.shape), tuple(want.shape), got.dtype, want.dtype)
    compare(name, got, want, exact=True)


def sync_source() -> str:
    """Where a synchronizing call was made, from inside the warning's hook:
    the innermost frame of the repository's own code, then the innermost
    frame of all (the library function that synchronized)."""
    stack = [f for f in traceback.extract_stack()[:-2]
             if os.path.basename(f.filename) != "warnings.py"]
    mine = [f for f in stack if f.filename.startswith(os.path.join(ROOT, "src"))]
    where = lambda f: f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
    inner = stack[-1]
    return (where(mine[-1]) if mine else "?") + f" -> {os.path.basename(inner.filename)}:" \
        f"{inner.lineno} {inner.name}"


def creation_timed(server) -> dict:
    """Wrap ``server._ensure_banks``, which ``step`` runs before the round's
    four phases: each cold ``SlotBank``'s warm-up (one window a rung and a
    snapshot, then ``event.synchronize()``) lies there, outside the wall
    split. Returns the live totals: seconds, calls, banks created."""
    timed = {"seconds": 0.0, "calls": 0, "banks": 0}
    inner = server._ensure_banks

    def ensure():
        t0 = time.perf_counter()
        created = inner()
        timed["seconds"] += time.perf_counter() - t0
        timed["calls"] += 1
        timed["banks"] += created
        return created

    server._ensure_banks = ensure
    return timed


def sync_counted(server) -> dict:
    """Wrap ``server``'s ADMIT and DISPATCH phases, and the bank creation
    before them, so that each counts the synchronizing CUDA calls it makes:
    the warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises inside
    it, by their source (:func:`sync_source`). Returns the live counters."""
    counted = {"admit": collections.Counter(), "dispatch": collections.Counter(),
               "create": collections.Counter()}

    def wrap(name, fn):
        def hook(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                counted[name][sync_source()] += 1

        def phase(*args):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        return phase

    server._admit_phase = wrap("admit", server._admit_phase)
    server._dispatch_phase = wrap("dispatch", server._dispatch_phase)
    server._ensure_banks = wrap("create", server._ensure_banks)
    return counted


def submit_all(server, workload):
    """Every request of ``workload`` submitted at once, then drained:
    ``(results, wall)``."""
    t0 = time.perf_counter()
    for _, req in workload:
        server.submit(req)
    results = server.drain()
    return results, time.perf_counter() - t0


def served_run(server, workload, drive=serve_launcher.drive):
    """``drive`` of ``workload`` (open loop by default, as the launcher
    runs it), its launch counts set to 0 just before and read just after:
    ``(results, wall, launches)``."""
    torch.cuda.synchronize()
    grid_tick.reset_launches()
    results, wall = drive(server, workload)
    torch.cuda.synchronize()
    return results, wall, dict(grid_tick.LAUNCHES)


def percentiles_ms(xs) -> dict:
    xs = np.asarray(xs) * 1e3
    return {f"p{q}_ms": float(np.percentile(xs, q)) for q in (50, 90, 99)} | {
        "mean_ms": float(xs.mean())}


def serve_summary(server, results, wall) -> dict:
    m = server.metrics()
    rungs = collections.Counter()
    for b in m["slot_banks"].values():
        rungs.update({int(k): v for k, v in b["rung_windows"].items()})
    return dict(
        requests=len(results), wall_s=wall, requests_per_s=len(results) / wall,
        latency=percentiles_ms([r.latency for r in results]),
        queue_delay=percentiles_ms([r.queue_delay for r in results]),
        rounds=m["rounds"], banks=len(server.banks), signatures=sorted(m["slot_banks"]),
        window=m["window"], rungs=m["rungs"], rung_windows=dict(sorted(rungs.items())),
        windows=sum(rungs.values()), coalesced=m["coalesced"], wall_split_s=m["wall_split_s"],
        occupancy_mean={k: b["occupancy_mean"] for k, b in m["slot_banks"].items()},
    )


def phase_sim_serve(dev) -> dict:
    """The port's ``SimServer`` on the card, parts (a)-(c) of the module
    docstring; returns the served runs' launches."""
    by_run = {}
    # (a) parity: every served row bitwise the card's Fleet.run at its pads
    p = SERVE_PARITY
    for leap in (False, True):
        for label, theta in (("base", None), ("theta", SERVE_THETA)):
            wl = synthetic_workload(p["n"], rate=p["rate"], seed=0, scale=p["scale"],
                                    replicas=p["replicas"], theta=theta)
            server = SimServer(ServeConfig(slots=p["slots"], replicas=p["replicas"], leap=leap),
                               device=dev)
            results, wall, launches = served_run(server, wl)
            mode = "leap" if leap else "tick"
            by_run[f"sim_serve_parity_{mode}_{label}"] = launches
            assert sorted(r.rid for r in results) == list(range(p["n"]))
            for _, req in wl:
                res = server.poll(req.rid)
                fleet = Fleet.from_pairs([(req.grid, req.campaign)], pad_floors=res.signature,
                                         leap=leap, device=dev)
                want = fleet.run(theta, replicas=p["replicas"], key=prng.PRNGKey(req.seed, dev))
                for f in want._fields:
                    same(f"served {mode} {label} rid {req.rid} {f}", getattr(res.result, f),
                         getattr(want, f)[0].cpu())
            emit("sim_serve", part="a_parity", mode=mode, params=label,
                 bitwise_vs_fleet_run=True, **serve_summary(server, results, wall),
                 launches={k: v for k, v in launches.items() if v})
    # (b) the reference benchmark's workload, open loop, tick; syncs by phase
    b = SERVE_BENCH
    wl = synthetic_workload(b["n"], rate=b["rate"], seed=0, scale=b["scale"],
                            replicas=b["replicas"])
    server = SimServer(ServeConfig(slots=b["slots"], replicas=b["replicas"]), device=dev)
    # the debug mode toggled once around no work: what the counting itself raises
    toggle = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    toggle.update(str(w.message) for w in caught)
    syncs = sync_counted(server)
    creation = creation_timed(server)
    results, wall, launches = served_run(server, wl)
    by_run["sim_serve_bench"] = launches
    assert sorted(r.rid for r in results) == list(range(b["n"]))
    for r in results:
        for f in ("transfer_time", "conth_mb", "conpr_mb", "start_tick"):
            assert bool(torch.isfinite(getattr(r.result, f)).all()), (r.rid, f)
    summary = serve_summary(server, results, wall)
    emit("sim_serve", part="b_bench", mode="tick", params="default",
         workload={k: b[k] for k in ("n", "rate", "scale", "replicas")}, slots=b["slots"],
         **summary, bank_creation_s=creation["seconds"], banks_created=creation["banks"],
         syncs={k: sum(c.values()) for k, c in syncs.items()},
         warnings_of_a_bare_toggle=dict(toggle),
         sync_sources={k: dict(c.most_common()) for k, c in syncs.items()},
         launches={k: v for k, v in launches.items() if v},
         done_share=float(np.mean([float(r.result.done.float().mean()) for r in results])))
    # (c) fleet width: 256 x 64 at t = 0, bitwise a warm batch run on the overlap
    c = SERVE_WIDE
    pairs = sample_scenarios(None, c["n"], 0, scale=c["scale"])
    keys = prng.split(prng.PRNGKey(0, dev), c["n"] * c["replicas"]).reshape(
        c["n"], c["replicas"], 2)
    fleet = Fleet.from_pairs(pairs, device=dev)
    fleet.run(keys=keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = fleet.run(keys=keys)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    host_keys = keys.cpu().numpy().astype(np.uint32)
    wl = [(0.0, SimRequest(rid=i, grid=g, campaign=cp, n_replicas=c["replicas"],
                           keys=host_keys[i], name=f"wide_{i}"))
          for i, (g, cp) in enumerate(pairs)]
    server = SimServer(ServeConfig(slots=c["slots"], replicas=c["replicas"]), device=dev)
    creation = creation_timed(server)
    results, wall, launches = served_run(server, wl, drive=submit_all)
    by_run["sim_serve_fleet_width"] = launches
    assert sorted(r.rid for r in results) == list(range(c["n"]))
    for r in results:
        for f in batch._fields:
            a, w = getattr(r.result, f), getattr(batch, f)[r.rid].cpu()
            sl = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, w.shape))
            same(f"fleet-width rid {r.rid} {f}", a[sl], w[sl])
    elements = c["n"] * c["replicas"]
    summary = serve_summary(server, results, wall)
    emit("sim_serve", part="c_fleet_width", mode="tick", params="default",
         bitwise_vs_batch_run=True, slots=c["slots"], replicas=c["replicas"], **summary,
         bank_creation_s=creation["seconds"], banks_created=creation["banks"],
         served_elements_per_s=elements / wall, batch_wall_s=batch_wall,
         batch_elements_per_s=elements / batch_wall,
         serve_vs_warm_batch=(elements / wall) / (elements / batch_wall),
         launches={k: v for k, v in launches.items() if v},
         grid_tick_bank_fused_launches=launches["grid_tick_bank_fused"])
    return {"by_run": by_run}


def phase_parity(dev) -> None:
    fleet = Fleet.from_scenarios(n=64, seed=0, device=dev)
    for leap in (False, True):
        params = fleet.params(bg_mu=2.0, bg_sigma=1.0)
        a = fleet.run(params, replicas=4, leap=leap, window=1)
        b = fleet.run(params, replicas=4, leap=leap, window=64)
        for f in a._fields:
            compare(f"K-invariance leap={leap} {f}", getattr(b, f), getattr(a, f), exact=True)
        emit("parity", check="window K=1 vs K=64 bitwise", leap=leap,
             scenarios=64, replicas=4, realized_ticks=int(a.ticks.max()))
    # the card's normals against the CPU path's, bit for bit
    keys = prng.split(prng.PRNGKey(42), 200_000)
    got = prng.normal(keys.to(dev), (11,)).cpu()
    want = prng.normal(keys, (11,))
    ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    emit("parity", check="normals card vs CPU path", draws=want.numel(),
         max_ulp=int(ulp.max()), mismatched=int((ulp > 0).sum()))
    if int(ulp.max()) != 0:
        raise AssertionError(f"card normals differ from the CPU path's by up to {int(ulp.max())} ulp")
    # the card's main path against the plain CPU path on a small bank
    small_gpu = Fleet.from_scenarios(n=7, seed=0, max_ticks=2000, device=dev)
    small_cpu = Fleet.from_scenarios(n=7, seed=0, max_ticks=2000, device="cpu")
    for label, kw in (("default", {}), ("stochastic", dict(bg_mu=2.0, bg_sigma=1.5))):
        for leap in (False, True):
            g = small_gpu.run(small_gpu.params(**kw), replicas=2, leap=leap)
            c = small_cpu.run(small_cpu.params(**kw), replicas=2, leap=leap)
            errs = {}
            for f in g._fields:
                errs[f] = compare(f"gpu vs cpu {label} leap={leap} {f}", getattr(g, f).cpu(),
                                  getattr(c, f), exact=False)
            emit("parity", check="card vs CPU path", params=label, leap=leap, scenarios=7,
                 replicas=2, max_abs_err=errs)
    # a small bucketed scale-3 fleet (one bucket past the narrow kernels):
    # the card against the CPU path, bitwise
    kw = dict(n=7, seed=14, scale=3.0, max_ticks=300, n_buckets=3, leap=True)
    gpu, cpu = Fleet.from_scenarios(**kw, device=dev), Fleet.from_scenarios(**kw, device="cpu")
    for leap in (False, True):
        g = gpu.run(gpu.params(bg_mu=2.0, bg_sigma=1.5), replicas=2, leap=leap)
        c = cpu.run(cpu.params(bg_mu=2.0, bg_sigma=1.5), replicas=2, leap=leap)
        for f in g._fields:
            compare(f"bucketed scale-3 gpu vs cpu leap={leap} {f}", getattr(g, f).cpu(),
                    getattr(c, f), exact=True)
        emit("parity", check="bucketed scale-3 fleet card vs CPU path bitwise", leap=leap,
             scenarios=7, replicas=2, bucket_pads=gpu.bucket_pad_floors)
    # the calibration fixture's run (theta (0.05, 40, 20), 2 replicas, key
    # 42, leap): ConPr is exactly 0 at the same legs on the card as on the
    # CPU (a link that carries one process adds exact zeros), and the Eq.-1
    # fits agree
    runs = {}
    for where in (dev, "cpu"):
        fleet = Fleet.from_scenarios(n=7, seed=0, max_ticks=2000, leap=True, device=where)
        runs[str(where)] = fleet.run(torch.tensor(THETA_TRUE), replicas=2, key=prng.PRNGKey(42))
    g, c = runs[str(dev)], runs["cpu"]
    zeros_g, zeros_c = (g.conpr_mb == 0).cpu(), c.conpr_mb == 0
    differ = int((zeros_g != zeros_c).sum())
    coef_g = calibration._eq1_coefficients(g).cpu()
    coef_c = calibration._eq1_coefficients(c)
    emit("parity", check="conpr exact zeros card vs CPU", theta=list(THETA_TRUE), replicas=2,
         key=42, leap=True, zeros_card=int(zeros_g.sum()), zeros_cpu=int(zeros_c.sum()),
         differ=differ, eq1_max_abs_diff=float((coef_g - coef_c).abs().max()))
    if differ:
        raise AssertionError(f"conpr_mb is exactly 0 at {differ} legs on one side only")
    compare("Eq.-1 coefficients card vs CPU", coef_g, coef_c, exact=False, rtol=1e-4, atol=1e-6)


def device_rows(prof, averages=None):
    """``(name, device us, count)`` of a profile's device-side events
    (kernels, copies), largest first: the CPU-side op events carry their
    kernels' time too and would count it twice. ``averages``: the
    profile's ``key_averages()`` where the caller has them already (each
    call walks every event again)."""
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    return sorted(
        ((e.key, dev_us(e), e.count) for e in averages or prof.key_averages()
         if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
         and e.key not in ANNOTATIONS),
        key=lambda r: -r[1],
    )


def range_device_s(averages, name: str) -> float:
    """Device seconds of the kernels launched inside the
    ``torch.profiler.record_function(name)`` ranges of a profile, from its
    ``key_averages()``."""
    total = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return max((total(e) for e in averages
                if e.key == name and not str(e.device_type).endswith("CUDA")), default=0) / 1e6


def profile_steps(fn, steps: int, wall_per_step: float) -> dict:
    """Device time per step of ``fn()`` (``steps`` steps) under
    ``torch.profiler``, beside the unprofiled wall per step of the same
    stage: their ratio is the device's busy share there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events alone
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    dev_s = sum(r[1] for r in rows) / 1e6 / steps
    return dict(device_s_per_step=dev_s, wall_s_per_step=wall_per_step,
                busy_share=dev_s / wall_per_step, device_launches_per_step=sum(r[2] for r in rows) / steps,
                top=[[k[:60], us / 1e6 / steps, n / steps] for k, us, n in rows[:6]])


def phase_profile(dev, main_run: dict) -> dict:
    """Where a main-path run's device time goes: one tick-mode and one
    leap-mode run (default params) under ``torch.profiler``; device time by
    kernel name, and the device's busy share of the run's unprofiled wall
    from phase main."""
    from torch.profiler import ProfilerActivity, profile

    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, device=dev)
    walls = {(r["mode"], r["params"]): r["wall_s"] for r in main_run["runs"]}
    out = {}
    for leap in (False, True):
        mode = "leap" if leap else "tick"
        # device activity alone: the host's ~100,000 op events of a tick
        # run cost the profiler tens of seconds and no device time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fleet.run(replicas=N_REP, leap=leap)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total_s = sum(r[1] for r in rows) / 1e6
        wall = walls[(mode, "default")]
        fused = sum(r[1] for r in rows if "bank_fused_kernel" in r[0]) / 1e6
        tick = sum(r[1] for r in rows if "bank_tick_kernel" in r[0]) / 1e6
        sums = sum(r[1] for r in rows if "bank_sums_kernel" in r[0]) / 1e6
        out[mode] = dict(
            device_s=total_s, wall_s=wall,
            busy_share=total_s / wall if total_s else None,
            grid_tick_kernels_s=fused + tick + sums, bank_sums_kernel_s=sums,
            device_kernels=len(rows),
            device_launches=sum(r[2] for r in rows),
            top=[[k[:70], us / 1e6, n] for k, us, n in rows[:8]],
        )
        emit("profile", mode=mode, params="default", **out[mode])
    return out


def timed(fn, reps: int):
    """``(ms, out)``: the mean ms of ``fn`` over ``reps`` calls (CUDA events)
    after a warm-up call, and that warm-up call's output."""
    out = fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def device_ms(fn, reps: int, tag=None, counted=None) -> float:
    """The mean device ms a call of ``fn`` over ``reps`` calls after a
    warm-up call: the kernels' time under ``torch.profiler`` (those whose
    name holds ``tag``, or all), without the host's time between launches.
    For a kernel faster than its host call, where CUDA events around a
    loop of calls time the host. The profiler misses the first device
    events of a trace (on an H100 a few to a few dozen launches, at times
    every launch of a short loop), so the ``reps`` calls are traced once
    as a warm-up step that is thrown away and again as the step that is
    read. The read step can miss its own first launches too (on an H100 the
    first 6 of 20 calls in six profiles in a row once), so each step
    starts with a burst of ``torch.cuda._sleep`` spin kernels that are not
    counted. A read step with no device event, or with a
    count of ``tag``'s kernels that is not a multiple of ``reps`` (each
    call launches the tagged kernel the same number of times), is taken
    again, up to six times (a read step missed launches in three profiles
    running on an H100 in a row once). ``counted``, a list, gets the read
    step's device launches a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(6):
        read = []  # the read step's rows: the profiler clears a step's events when it ends
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: read.append(device_rows(p))) as prof:
            for _step in range(2):
                for _ in range(32):
                    torch.cuda._sleep(5000)
                torch.cuda.synchronize()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [r for r in (read[0] if read else []) if "spin_kernel" not in r[0]]
        tagged = [r for r in rows if tag is None or tag in r[0]]
        launches = sum(r[2] for r in tagged)
        if rows and (tag is None or (launches and launches % reps == 0)):
            if counted is not None:
                counted.append(launches / reps)
            return sum(r[1] for r in tagged) / 1e3 / reps
        seen.append(launches)
    raise AssertionError(f"torch.profiler recorded no device time, or not every launch of "
                         f"{tag!r} ({reps} calls), in six profiles: {seen} launches")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def first_window(spec, p, R: int, dev, K: int = 32):
    """``(state, noise, mu, sigma, consts)``: the stochastic tick run's first
    carry on ``spec`` (a stacked spec on the card) x ``R`` replicas with
    bank-wide params ``p``, ``K`` noise rows from a seed, and the window's
    constants in ``ref.grid_tick_bank_window``'s order."""
    S = spec.size_mb.shape[0]
    L = spec.bandwidth.shape[-1]
    mu, sigma = p.bg_mu[:, None].contiguous(), p.bg_sigma[:, None].contiguous()
    consts = (spec.release, spec.dep, spec.bg_period, spec.max_ticks, p.keep_frac,
              spec.bandwidth, spec.leg_proc, spec.proc_link, spec.leg_link)
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64, device=dev))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.randn((K, S, R, L), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    return state, noise, mu, sigma, consts


def tick_inputs(spec, p, R: int, dev):
    """The one-tick kernel's arguments on ``spec`` x ``R`` replicas as the
    leap scan calls it (``remaining = inf``): half the valid legs active,
    random background loads, from a seed."""
    S, T = spec.size_mb.shape
    L = spec.bandwidth.shape[-1]
    f32 = torch.float32
    g = torch.Generator(device="cpu").manual_seed(2)
    active = (torch.rand((S, R, T), generator=g) < 0.5).to(dev).to(f32) * spec.leg_valid[:, None].to(f32)
    remaining = torch.full((S, R, T), float("inf"), dtype=f32, device=dev)
    bg = torch.rand((S, R, L), generator=g).to(dev)
    return (active, remaining, p.keep_frac.contiguous(), bg, spec.bandwidth.to(f32),
            spec.bank_tables)


def long_tail_bucket(sub, dev):
    """``(spec, p, R)``: a bucket ``sub`` of the long-tail fleet as the
    bucketed dispatch runs it at ``N_REP`` replicas (a singleton bucket
    folded over its replicas), with bank-wide stochastic params."""
    fold = engine._replica_fold(N_REP) if sub.n_scenarios == 1 else 1
    spec = engine._folded_spec(sub, fold, dev) if fold > 1 else engine.bank_spec(sub, dev)
    p = engine.make_bank_params(sub, bg_mu=2.0, bg_sigma=1.0, device=dev)
    p = engine.SimParams(*(None if f is None else f.expand((spec.size_mb.shape[0],) + tuple(
        f.shape[1:])).contiguous() for f in p))
    return spec, p, N_REP // fold


def widest_long_tail(dev):
    """:func:`long_tail_bucket` of the long-tail fleet's widest bucket (S 3,
    R 64, T 196, P 196, L 2)."""
    fleet = Fleet.from_scenarios(**LONG_TAIL, device=dev)
    return long_tail_bucket(max(fleet.bank.buckets, key=lambda b: b.bank.pad_legs).bank, dev)


def wide_main_path_shapes(dev):
    """``(label, spec, p, R)`` of each shape at which the main path runs
    the wide instances: the serving bench's widest slot bank and every wide
    bucket of the long-tail fleet."""
    out = [("serve_256", *serve_wide_bank(dev))]
    fleet = Fleet.from_scenarios(**LONG_TAIL, device=dev)
    for b in fleet.bank.buckets:
        sub = b.bank
        if grid_tick._wide(sub.pad_legs, sub.pad_procs, sub.pad_links):
            out.append((f"long_tail_T{sub.pad_legs}", *long_tail_bucket(sub, dev)))
    return out


def serve_wide_bank(dev):
    """``(spec, p, R)``: the serving bench's widest slot bank (its requests
    at pad signature (256, 256, 8), 4 replicas each) with bank-wide
    stochastic params."""
    b = SERVE_BENCH
    wl = synthetic_workload(b["n"], rate=b["rate"], seed=0, scale=b["scale"],
                            replicas=b["replicas"])
    sig = (256, 256, 8)
    pairs = [(r.grid, r.campaign) for _, r in wl
             if serve_cache.pad_signature(workload.compile_campaign(r.grid, r.campaign)) == sig]
    bank = Fleet.from_pairs(pairs, pad_floors=sig, device=dev).bank
    spec = engine.bank_spec(bank, dev)
    return spec, engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev), b["replicas"]


def time_bank_kernels(spec, p, R: int, dev, names=BANK_KERNELS) -> dict:
    """Each bank kernel and its plain version on ``spec`` x ``R`` replicas
    with bank-wide params ``p``: the fused kernel over one K=32 window of
    :func:`first_window`, the one-tick kernel with ``remaining = inf`` as
    the leap scan calls it, the sums kernel on that tick's transfers. The
    outputs are held against each other, then timed: ``ms`` is profiler
    device time, ``events_ms`` CUDA events around a loop of calls (which
    at the wide shapes time the host's launch); ``names`` are the rows'
    names."""
    S, T = spec.size_mb.shape
    P, L = spec.leg_proc.shape[-1], spec.bandwidth.shape[-1]
    K = 32
    state, noise, mu, sigma, consts = first_window(spec, p, R, dev, K)
    tables = spec.bank_tables
    f32 = torch.float32
    args = (state, noise, mu, sigma, *consts[:6], tables)
    fused = lambda: grid_tick.grid_tick_bank_fused_cuda(*args)
    fused_events_ms, got = timed(fused, 20)
    fused_ms = device_ms(fused, 20, "bank_fused")
    alive_steps = int(got[1].sum())
    plain_fused_ms, want = timed(lambda: ref.grid_tick_bank_window(
        state, mu, sigma, *consts, leap=False, noise=noise, tables=tables), 2)
    fused_errs = {name: compare(f"fused {name} at {names[0]} shapes", g_, w_, exact=True)
                  for name, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want)}
    # bytes: carry in and out once, the window's noise, the scenario tables
    fused_bytes = 2 * nbytes(*state) + nbytes(noise, mu, sigma, *consts[:6], tables.packed)
    # fp32 operations per alive element-tick: ~14 per leg (share, sums,
    # accumulators) and ~5 per link (resample, fair-share denominator)
    fused_ops = alive_steps * (14 * T + 5 * L)
    fused_bound = max(fused_bytes / PEAK_BYTES, fused_ops / PEAK_FP32) * 1e3
    fused_by = "bytes" if fused_bytes / PEAK_BYTES >= fused_ops / PEAK_FP32 else "operations"

    targs = tick_inputs(spec, p, R, dev)
    active, remaining, keep, bg = targs[:4]
    tick = lambda: grid_tick.grid_tick_bank_cuda(*targs)
    tick_events_ms, got = timed(tick, 50)
    tick_ms = device_ms(tick, 50, "bank_tick")
    plain_tick_ms, want = timed(lambda: ref.grid_tick_bank_indexed(
        active, remaining, keep, bg, spec.bandwidth, spec.leg_proc, spec.proc_link, tables), 5)
    tick_errs = {n: compare(f"tick {n} at {names[1]} shapes", g_, w_, exact=True)
                 for n, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want)}
    tick_bytes = nbytes(active, remaining, keep, bg, spec.bandwidth, tables.packed) + 4 * S * R * (T + P + L)
    tick_ops = S * R * (14 * T + 5 * L)
    tick_bound = max(tick_bytes / PEAK_BYTES, tick_ops / PEAK_FP32) * 1e3
    tick_by = "bytes" if tick_bytes / PEAK_BYTES >= tick_ops / PEAK_FP32 else "operations"

    # the sums kernel on the tick's transfers, as the leap step calls it;
    # device time (a launch is shorter than its host call). Library: one
    # bmm against the legs' process and link columns (a link over its legs)
    v = got[0]
    sums_ms = device_ms(lambda: grid_tick.grid_tick_bank_sums_cuda(v, tables), 50, "bank_sums")
    sums_events_ms, got_s = timed(lambda: grid_tick.grid_tick_bank_sums_cuda(v, tables), 50)
    plain_sums_ms, want_s = timed(lambda: ref.bank_sums(v, tables), 5)
    sums_errs = {n: compare(f"sums {n} at {names[2]} shapes", g_, w_, exact=True)
                 for n, g_, w_ in zip(("proc", "link"), got_s, want_s)}
    columns = torch.cat([spec.leg_proc, spec.leg_link], dim=2).to(f32).contiguous()
    lib_sums_ms, lib_out = timed(lambda: torch.bmm(v, columns), 50)
    compare("sums vs bmm", lib_out, torch.cat(want_s, dim=2), exact=False)
    sums_bytes = nbytes(v, tables.packed) + 4 * S * R * (P + L)
    sums_ops = R * int(tables.proc_ptr[:, -1].sum() + tables.link_proc_ptr[:, -1].sum())
    sums_bound = max(sums_bytes / PEAK_BYTES, sums_ops / PEAK_FP32) * 1e3
    sums_by = "bytes" if sums_bytes / PEAK_BYTES >= sums_ops / PEAK_FP32 else "operations"
    return {
        names[0]: dict(ms=fused_ms, events_ms=fused_events_ms, plain_ms=plain_fused_ms,
                       bound_ms=fused_bound,
                       bound_by=fused_by, bytes=fused_bytes, ops=fused_ops,
                       shape=[K, S, R, T, P, L], alive_steps=alive_steps,
                       max_abs_err=fused_errs),
        names[1]: dict(ms=tick_ms, events_ms=tick_events_ms, plain_ms=plain_tick_ms,
                       bound_ms=tick_bound,
                       bound_by=tick_by, bytes=tick_bytes, ops=tick_ops,
                       shape=[S, R, T, P, L], max_abs_err=tick_errs),
        names[2]: dict(ms=sums_ms, events_ms=sums_events_ms, plain_ms=plain_sums_ms,
                       bound_ms=sums_bound, bound_by=sums_by, bytes=sums_bytes,
                       ops=sums_ops, library_ms=lib_sums_ms,
                       shape=[S, R, T, P, L], max_abs_err=sums_errs),
    }


def phase_timing(dev) -> dict:
    """The bank kernels at the main path's shapes (the 1,024-scenario bank
    x 64 replicas), then their wide instances at the shapes of the
    long-tail fleet's widest bucket as the bucketed dispatch runs it (a
    singleton bucket folded over its replicas)."""
    bank = build_bank(n=N_SCEN, seed=0)
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    res = time_bank_kernels(spec, p, N_REP, dev)
    res.update(time_bank_kernels(*widest_long_tail(dev), dev, names=WIDE_KERNELS))
    emit("timing", card=smi(), **res)
    return res


def mlp_net(n: int, f_in: int, dev, seed: int = 0):
    """Random LeCun-scaled weights of the classifier's shape and ``n``
    unit-box input rows, made from a seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dims = [f_in] + [MLP_HIDDEN] * MLP_DEPTH + [1]
    ws = [(torch.randn(a, b, generator=g) / a ** 0.5).to(dev) for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * torch.randn(b, generator=g)).to(dev) for b in dims[1:]]
    return torch.rand(n, f_in, generator=g).to(dev), ws, bs


def mlp_grads(fn, x, ws, bs):
    """Gradients of the classifier's BCE loss (half the rows labelled 1)
    through ``fn(x, ws, bs)``."""
    labels = (torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2).float()
    leaves = [p.clone().requires_grad_() for p in ws + bs]
    logits = fn(x, leaves[:len(ws)], leaves[len(ws):])[:, 0]
    loss = (logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()
    return torch.autograd.grad(loss, leaves)


def phase_selu_mlp(dev) -> dict:
    """The SELU-MLP kernel against its plain version at the calibration
    path's shapes: N = 8,192 (every scenario's chains in one MCMC step),
    N = 4,096 (a training batch), N = 4 (the Section-5 launcher's chains in
    one MCMC step) and a ragged N = 37, F_in = 15. Forward outputs and
    pre-activations within rtol/atol 1e-5 (the same ascending sums; expm1
    may round differently), and bitwise equal (the kernel keeps the plain
    version's order of rounded operations, and the card-vs-CPU chain rests
    on it: a differing bit fails the phase); the autograd gradients of the BCE loss within 1e-4 of each tensor's largest
    entry (sums over the batch in torch matmuls, from slightly different
    forwards). The forward is timed at every N with CUDA events and as
    device time under ``torch.profiler`` (at small N the events time the
    host's launch); the kernel line carries the MCMC shape."""
    out = {}
    for n in (8192, 4096, 37, 4):
        x, ws, bs = mlp_net(n, MLP_IN, dev, seed=n)
        got, pre = selu_mlp.selu_mlp_cuda(x, ws, bs, save_pre=True)
        want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
        err = max(compare(f"selu_mlp N={n} out", got, want, False, 1e-5, 1e-5),
                  compare(f"selu_mlp N={n} pre", pre, want_pre, False, 1e-5, 1e-5))
        bitwise = bool(torch.equal(got, want) and torch.equal(pre, want_pre))
        if not bitwise:
            raise AssertionError(f"selu_mlp N={n}: the kernel is not bitwise the plain version")
        g_k = mlp_grads(ops.selu_mlp, x, ws, bs)
        g_p = mlp_grads(lambda a, w, b: ref.selu_mlp(a, w, b), x, ws, bs)
        grad_rel = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        if grad_rel > 1e-4:
            raise AssertionError(f"selu_mlp N={n} gradients differ: {grad_rel} of the largest entry")
        kernel = lambda: selu_mlp.selu_mlp_cuda(x, ws, bs)
        ms, _ = timed(kernel, 200)
        dev_ms = device_ms(kernel, 200, "selu_mlp_kernel")
        plain_ms, _ = timed(lambda: ref.selu_mlp(x, ws, bs), 3)
        # operations: a multiply and an add per weight per row; bytes: the
        # input rows and weights read once, the logits written once. The
        # kernel keeps the plain version's rounded multiply, rounded add
        # (no FMA), so its own floor executes both: twice the FMA bound
        ops_ = 2 * n * (MLP_IN * MLP_HIDDEN + (MLP_DEPTH - 1) * MLP_HIDDEN ** 2 + MLP_HIDDEN)
        bytes_ = nbytes(x, *ws, *bs) + 4 * n
        bound = max(bytes_ / PEAK_BYTES, ops_ / PEAK_FP32) * 1e3
        out[n] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_ms_no_fma=max(bytes_ / PEAK_BYTES, 2 * ops_ / PEAK_FP32) * 1e3,
                      bound_by="bytes" if bytes_ / PEAK_BYTES >= ops_ / PEAK_FP32 else "operations",
                      ops=ops_, bytes=bytes_, max_abs_err=err, bitwise=bitwise,
                      grad_max_rel_err=grad_rel,
                      tile=list(selu_mlp.tile(n, MLP_IN, MLP_HIDDEN)))
        emit("calibrate", check="selu_mlp kernel vs plain", N=n, F_in=MLP_IN, card=smi(),
             library_ms=None, library="none: no single PyTorch call computes the SELU MLP",
             **out[n])
    torch.cuda.synchronize()
    return out


LLM_KERNELS = (flash_attention, decode_attention, mlstm_chunk)


def reset_counts() -> None:
    grid_tick.reset_launches()
    selu_mlp.reset_launches()
    for k in LLM_KERNELS:
        k.reset_launches()


def counts() -> dict:
    out = {**grid_tick.LAUNCHES, **selu_mlp.LAUNCHES}
    for k in LLM_KERNELS:
        out.update(k.LAUNCHES)
    return out


def phase_calibrate(dev) -> dict:
    """The amortized calibration path at full width on the card, stage by
    stage, each stage's launches counted from 0."""
    cfg = CalibrationConfig()
    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, leap=True, device=dev)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stages[name] = dict(seconds=time.perf_counter() - t0, launches=counts())
        return res

    # the observation: per-scenario medians of 8 replicas at a known theta
    coefs = stage("x_true", lambda: fleet.coefficients(
        torch.tensor(THETA_TRUE), replicas=8, key=prng.PRNGKey(42, dev)))
    x_true = calibration._median(coefs, 1)
    assert tuple(x_true.shape) == (N_SCEN, 3) and bool(torch.isfinite(x_true).all())
    key = prng.PRNGKey(0, dev)
    # presimulation alone, as Fleet.calibrate runs it (same key and batch),
    # for its seconds; calibrate then runs it again ahead of training
    n_per = -(-cfg.n_presim // N_SCEN)
    theta, x_sim, sid = stage("presimulate", lambda: fleet.presimulate(
        calibration.PriorBox.paper(), prng.split(key, 2)[1], n_per, batch=min(128, n_per),
        leap=cfg.use_leap))
    assert tuple(theta.shape) == (N_SCEN * n_per, 3) and bool(torch.isfinite(x_sim).all())
    post = stage("calibrate", lambda: fleet.calibrate(x_true, key, cfg, amortized=True))
    stages["train"] = dict(seconds=stages["calibrate"]["seconds"] - stages["presimulate"]["seconds"],
                           launches={"selu_mlp": stages["calibrate"]["launches"]["selu_mlp"]})
    theta_star, stats = stage("mcmc", lambda: post.theta_star_all(
        prng.PRNGKey(1, dev), return_stats=True))
    if tuple(theta_star.shape) != (N_SCEN, 3) or not bool(torch.isfinite(theta_star).all()):
        raise AssertionError(f"theta_star not finite [{N_SCEN}, 3]: {tuple(theta_star.shape)}")
    val = stage("validate", lambda: fleet.validate(theta_star, x_true, prng.PRNGKey(2, dev)))
    # a fit whose normal matrix is singular in float32 is NaN, as in the
    # reference; nearly all must be finite
    finite = float(np.isfinite(val["coefficients"]).all(-1).mean())
    if val["coefficients"].shape != (N_SCEN, 64, 3) or finite < 0.99:
        raise AssertionError(f"validation: {val['coefficients'].shape}, finite share {finite}")
    for name, want in (("calibrate", ("selu_mlp", "grid_tick_bank", "grid_tick_bank_sums")),
                       ("mcmc", ("selu_mlp",)), ("validate", ("grid_tick_bank", "grid_tick_bank_sums"))):
        for k in want:
            if stages[name]["launches"][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched in stage {name}")
    mcmc_steps = cfg.burn_in + cfg.n_mcmc
    res = dict(
        scenarios=N_SCEN, presim_tuples=int(theta.shape[0]), epochs=cfg.epochs,
        batch_size=cfg.batch_size, chains=N_SCEN * cfg.n_chains, mcmc_steps=mcmc_steps,
        train_loss=post.train_loss, train_accuracy=post.train_accuracy,
        accept_rate_mean=float(stats["accept_rate"].mean()),
        accept_rate_min=float(stats["accept_rate"].min()),
        rhat_max=float(stats["rhat"].max()),
        rhat_median=float(stats["rhat"].max(dim=1).values.median()),
        theta_star_shape=list(theta_star.shape),
        theta_star_median=theta_star.median(dim=0).values.tolist(),
        theta_true=list(THETA_TRUE),
        validate_finite_share=finite,
        validate_mean_abs_error_median=np.nanmedian(val["mean_abs_error"], axis=0).tolist(),
        stages=stages,
    )
    emit("calibrate", **res)

    # where the time goes: a 201-step MCMC over every scenario's chains and
    # one training epoch on the presimulated tuples, profiled
    prof = {}
    prof["mcmc"] = profile_steps(
        lambda: post.theta_star_all(prng.PRNGKey(1, dev), n_samples=150, burn_in=50),
        201, stages["mcmc"]["seconds"] / (mcmc_steps + 1))
    theta_u = calibration.PriorBox.paper(dev).to_unit(theta)
    x_lo, x_hi = (torch.tensor(v, device=dev) for v in (cfg.x_low, cfg.x_high))
    x_u = torch.clamp((x_sim - x_lo) / (x_hi - x_lo), 0.0, 1.0)
    train_steps = cfg.epochs * -(-theta.shape[0] // cfg.batch_size)
    prof["train"] = profile_steps(
        lambda: classifier.train_classifier(
            prng.PRNGKey(5, dev), classifier.ClassifierConfig(context_dim=post.n_features, lr=cfg.lr),
            theta_u, x_u, post.features[sid.long()], epochs=1, batch_size=cfg.batch_size),
        train_steps // cfg.epochs, stages["train"]["seconds"] / train_steps)
    for name, p_ in prof.items():
        emit("calibrate", profile=name, **p_)
    res["profile"] = prof

    # a chain on the card against the CPU path, from the same converted
    # weights and key: samples within 1e-5
    cpu_params = classifier_from_reference(classifier_to_reference(post.classifier_params), "cpu")
    x0, ctx0 = post.x_true_unit[0], post.features[0]
    key = prng.PRNGKey(3)
    a = mcmc.run_chain(post.classifier_params, x0, key, n_samples=150, burn_in=50, context=ctx0)
    b = mcmc.run_chain(cpu_params, x0.cpu(), key, n_samples=150, burn_in=50, context=ctx0.cpu())
    err = compare("run_chain card vs CPU", a.samples.cpu(), b.samples, False, 0.0, 1e-5)
    if float(a.accept_rate) != float(b.accept_rate):
        raise AssertionError(f"accept rate card {float(a.accept_rate)} vs CPU {float(b.accept_rate)}")
    emit("calibrate", check="run_chain 200 steps card vs CPU path", max_abs_err=err,
         accept_rate=float(a.accept_rate))
    return res


def section5_table():
    return workload.compile_campaign(*workload.wlcg_production_workload(seed=0))


def random_campaign(T, P, L, seed):
    """One-hot incidences of a random campaign past the bank kernels' 128
    legs: every leg in one process, every process on one link."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.nn.functional.one_hot(torch.randint(0, P, (T,), generator=g), P).float()
    pl = torch.nn.functional.one_hot(torch.randint(0, L, (P,), generator=g), L).float()
    return lp, pl, lp @ pl


def campaign_tick_inputs(B, T, L, dev, per_row: bool, inf: bool, seed: int = 0):
    """A random ``[B, T]`` tick state: 0/1 active flags, remaining MB (or
    ``inf``, as the leap calls the tick), keep ``[T]`` or ``[B, T]``,
    background load ``[B, L]``."""
    g = torch.Generator().manual_seed(seed)
    a = (torch.rand(B, T, generator=g) < 0.6).float()
    rem = torch.full((B, T), float("inf")) if inf else 50 * torch.rand(B, T, generator=g)
    keep = 0.9 + 0.1 * torch.rand((B, T) if per_row else (T,), generator=g)
    bg = 3 * torch.rand(B, L, generator=g)
    return tuple(x.to(dev) for x in (a, rem, keep, bg))


def check_campaign_kernel(label, a, rem, keep, bg, bw, lp, pl, ll) -> float:
    """The per-campaign tick against ``ref.grid_tick_indexed`` (bitwise)
    and ``ref.grid_tick`` (within RTOL/ATOL), then the per-campaign sums
    launch on the tick's transfers against ``ref.bank_sums`` at S = 1
    (bitwise); the max abs error against the one-hot matmul."""
    tables = ref.campaign_index_tables(lp, pl, ll)
    got = grid_tick.grid_tick_cuda(a, rem, keep, bg, bw, tables)
    want = ref.grid_tick_indexed(a, rem, keep, bg, bw, lp, pl, tables)
    for name, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want):
        compare(f"grid_tick {label} {name} vs indexed", g_, w_, exact=True)
    plain_sums = ref.bank_sums(want[0][None], tables)
    for name, g_, w_ in zip(("proc", "link"), grid_tick.grid_tick_sums_cuda(want[0], tables),
                            plain_sums):
        compare(f"grid_tick_sums {label} {name}", g_, w_[0], exact=True)
    plain = ref.grid_tick(a, rem, keep, bg, bw, lp, pl, ll)
    return max(compare(f"grid_tick {label} {name}", g_, w_, exact=False)
               for name, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, plain))


def phase_campaign_kernel(dev) -> float:
    """The per-campaign tick and sums against their plain versions: the
    Section-5 campaign at B = 7 and at the main shape B = 2,048 (shared and
    per-row keep, finite and infinite remaining), and a 700-leg campaign
    (the wide instance)."""
    spec = engine.SimSpec.from_table(section5_table(), max_ticks=SECTION5_MAX_TICKS, device=dev)
    inc = (spec.leg_proc, spec.proc_link, spec.leg_link)
    T, P, L = spec.n_legs, spec.leg_proc.shape[1], spec.n_links
    err = 0.0
    for B in (7, CAMPAIGN_B):
        for per_row in (False, True):
            for inf in (False, True):
                x = campaign_tick_inputs(B, T, L, dev, per_row, inf, seed=B)
                e = check_campaign_kernel(f"B={B}", *x, spec.bandwidth, *inc)
                emit("kernels", kernel="grid_tick", B=B, T=T, P=P, L=L, per_row_keep=per_row,
                     remaining_inf=inf, bitwise_vs_indexed=True, sums_bitwise=True,
                     max_abs_err=e)
                err = max(err, e)
    T2, P2, L2, B2 = 700, 90, 40, 300
    inc2 = tuple(m.to(dev) for m in random_campaign(T2, P2, L2, seed=3))
    bw2 = (1 + 100 * torch.rand(L2, generator=torch.Generator().manual_seed(4))).to(dev)
    e = check_campaign_kernel("T=700", *campaign_tick_inputs(B2, T2, L2, dev, True, False, 5),
                              bw2, *inc2)
    emit("kernels", kernel="grid_tick", B=B2, T=T2, P=P2, L=L2, per_row_keep=True,
         bitwise_vs_indexed=True, sums_bitwise=True, max_abs_err=e)
    torch.cuda.synchronize()
    return max(err, e)


def phase_campaign(dev) -> dict:
    """``simulate_batch`` of the Section-5 campaign at B = 2,048 through
    the per-campaign tick (and, in leap mode, the sums launch): tick and
    leap, the campaign's own (deterministic) background load and the
    launcher's stochastic theta; each timed run's launches counted from 0.
    Then window invariance (K = 1 vs K = 64, bitwise), the card against the
    CPU path (bitwise), and the two launches' times at the main shape
    beside their bounds."""
    table = section5_table()
    spec = engine.SimSpec.from_table(table, max_ticks=SECTION5_MAX_TICKS, device=dev)
    mapper = calibration.make_theta_mapper(table, device=dev)
    theta = torch.tensor(THETA_SECTION5, device=dev)
    params = {"default": engine.make_params(table, device=dev), "stochastic": mapper(theta)}
    keys = prng.split(prng.PRNGKey(0, dev), CAMPAIGN_B)
    short = spec._replace(max_ticks=64)
    runs = []
    for leap in (False, True):
        for label, p in params.items():
            engine.simulate_batch(short, p, keys, leap=leap)  # warm-up
            torch.cuda.synchronize()
            engine.STATS["windows"] = 0
            reset_counts()
            t0 = time.perf_counter()
            res = engine.simulate_batch(spec, p, keys, leap=leap)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
            for f in ("transfer_time", "conth_mb", "conpr_mb", "start_tick"):
                x = getattr(res, f)
                assert tuple(x.shape) == (CAMPAIGN_B, spec.n_legs), (f, tuple(x.shape))
                assert bool(torch.isfinite(x).all()), f"{f} not finite"
            if launches["grid_tick"] <= 0:
                raise AssertionError(f"grid_tick was not launched in the {label} run (leap={leap})")
            # a leap event step takes its last tick's sums in one launch
            if launches["grid_tick_sums"] != (launches["grid_tick"] if leap else 0):
                raise AssertionError(f"grid_tick_sums {launches['grid_tick_sums']} launches, "
                                     f"grid_tick {launches['grid_tick']} (leap={leap})")
            run = dict(mode="leap" if leap else "tick", params=label, sims=CAMPAIGN_B, wall_s=wall,
                       sims_per_s=CAMPAIGN_B / wall, windows=engine.STATS["windows"],
                       realized_ticks=int(res.ticks.max()),
                       done_share=float(res.done.float().mean()), launches=launches)
            emit("campaign", **run)
            runs.append(run)

    # where a run's time goes: the stochastic tick run cut at 100 ticks and
    # the stochastic leap run at 3,000, unprofiled wall then device time by
    # kernel
    from torch.profiler import ProfilerActivity, profile

    prof = {}
    for leap, cut in ((False, 100), (True, 3000)):
        s_ = spec._replace(max_ticks=cut)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.simulate_batch(s_, params["stochastic"], keys, leap=leap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as pr:  # device events alone
            engine.simulate_batch(s_, params["stochastic"], keys, leap=leap)
            torch.cuda.synchronize()
        rows = device_rows(pr)
        dev_s = sum(r[1] for r in rows) / 1e6
        mode = "leap" if leap else "tick"
        prof[mode] = dict(
            max_ticks=cut, wall_s=wall, device_s=dev_s, busy_share=dev_s / wall,
            grid_tick_kernel_s=sum(r[1] for r in rows if "bank_tick_kernel" in r[0]) / 1e6,
            grid_tick_sums_kernel_s=sum(r[1] for r in rows if "bank_sums_kernel" in r[0]) / 1e6,
            device_launches=sum(r[2] for r in rows),
            top=[[k[:60], us / 1e6, n] for k, us, n in rows[:6]],
        )
        emit("campaign", profile=mode, params="stochastic", sims=CAMPAIGN_B, **prof[mode])

    # window invariance on 64 simulations (stochastic theta, per-sim keep),
    # the tick run cut at 2,000 ticks
    th = calibration.PriorBox.paper(dev).from_unit(
        prng.uniform(prng.PRNGKey(1, dev), (64, 3)))
    p64, k64 = mapper(th), prng.split(prng.PRNGKey(2, dev), 64)
    for leap, cut in ((False, 2000), (True, SECTION5_MAX_TICKS)):
        t0 = time.perf_counter()
        s_ = spec._replace(max_ticks=cut)
        a = engine.simulate_batch(s_, p64, k64, leap=leap, window=1)
        b = engine.simulate_batch(s_, p64, k64, leap=leap, window=64)
        for f in a._fields:
            compare(f"campaign K-invariance leap={leap} {f}", getattr(b, f), getattr(a, f),
                    exact=True)
        emit("campaign", check="window K=1 vs K=64 bitwise", leap=leap, sims=64,
             max_ticks=cut, realized_ticks=int(a.ticks.max()), done_legs=int(a.done.sum()),
             legs=a.done.numel(), seconds=time.perf_counter() - t0)
    # the card against the CPU path: 4 simulations, stochastic theta
    cpu_spec = engine.SimSpec.from_table(table, max_ticks=SECTION5_MAX_TICKS, device="cpu")
    cpu_p = calibration.make_theta_mapper(table, device="cpu")(theta.cpu())
    for leap, cut in ((False, 500), (True, SECTION5_MAX_TICKS)):
        t0 = time.perf_counter()
        g = engine.simulate_batch(spec._replace(max_ticks=cut), params["stochastic"],
                                  keys[:4], leap=leap)
        c = engine.simulate_batch(cpu_spec._replace(max_ticks=cut), cpu_p, keys[:4].cpu(),
                                  leap=leap)
        errs = {f: compare(f"campaign card vs CPU leap={leap} {f}", getattr(g, f).cpu(),
                           getattr(c, f), exact=True) for f in g._fields}
        emit("campaign", check="card vs CPU path, bitwise", leap=leap, sims=4, max_ticks=cut,
             realized_ticks=int(c.ticks.max()), done_legs=int(c.done.sum()), legs=c.done.numel(),
             max_abs_err=errs, seconds=time.perf_counter() - t0)

    # the tick at the main shape, as presimulation's leap calls it: one
    # keep per row, remaining = inf
    T, P, L = spec.n_legs, spec.leg_proc.shape[1], spec.n_links
    a, rem, keep, bg = campaign_tick_inputs(CAMPAIGN_B, T, L, dev, per_row=True, inf=True)
    tables = spec.campaign_tables
    launch = lambda: grid_tick.grid_tick_cuda(a, rem, keep, bg, spec.bandwidth, tables)
    # a launch's device time is shorter than the wrapper's host time, so
    # CUDA events around back-to-back launches time the host: each launch's
    # own time is its device time under the profiler
    wall_ms, got = timed(launch, 200)
    ms = device_ms(launch, 200, "bank_tick_kernel")
    plain_ms, want = timed(lambda: ref.grid_tick_indexed(a, rem, keep, bg, spec.bandwidth,
                                                         spec.leg_proc, spec.proc_link, tables), 20)
    err = max(compare(f"grid_tick main shape {n}", g_, w_, exact=True)
              for n, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want))
    err = max(err, *(compare(f"grid_tick main shape {n} vs one-hot matmul", g_, w_, exact=False)
                     for n, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, ref.grid_tick(
                         a, rem, keep, bg, spec.bandwidth, spec.leg_proc, spec.proc_link,
                         spec.leg_link))))
    # bytes: the [B, T] inputs and bg read once, the tables, the outputs
    # written once; operations per row: five per leg for the share, an add
    # per list position for the two transfer sums, a few per process and link
    nnz = int(tables.proc_ptr[0, -1]) + int(tables.link_proc_ptr[0, -1])
    bytes_ = nbytes(a, rem, keep, bg, spec.bandwidth, tables.packed, *got)
    ops_ = CAMPAIGN_B * (5 * T + nnz + 2 * P + 4 * L)
    bound = max(bytes_ / PEAK_BYTES, ops_ / PEAK_FP32) * 1e3
    timing = dict(ms=ms, wall_ms_per_launch=wall_ms, plain_ms=plain_ms, bound_ms=bound,
                  bound_by="bytes" if bytes_ / PEAK_BYTES >= ops_ / PEAK_FP32 else "operations",
                  bytes=bytes_, ops=ops_, shape=[CAMPAIGN_B, T, P, L], max_abs_err=err,
                  library_ms=None)
    emit("campaign", check="grid_tick kernel timing", card=smi(),
         library="none: no single PyTorch call computes the tick", **timing)

    # the sums launch on that tick's transfers, as the leap step calls it;
    # library: the one-hot matmul it replaces (cuBLAS), timed here only
    v = got[0]
    sums = lambda: grid_tick.grid_tick_sums_cuda(v, tables)
    sums_ms = device_ms(sums, 200, "bank_sums_kernel")
    sums_wall_ms, got_s = timed(sums, 200)
    plain_sums_ms, want_s = timed(lambda: ref.bank_sums(v[None], tables), 20)
    sums_err = max(compare(f"grid_tick_sums main shape {n}", g_, w_[0], exact=True)
                   for n, g_, w_ in zip(("proc", "link"), got_s, want_s))
    columns = torch.cat([spec.leg_proc, spec.leg_link], dim=-1).contiguous()
    lib_sums_ms = device_ms(lambda: v @ columns, 200)
    compare("grid_tick_sums vs one-hot matmul", torch.cat(got_s, dim=-1), v @ columns, exact=False)
    sums_bytes = nbytes(v, tables.packed, *got_s)
    sums_ops = CAMPAIGN_B * nnz
    sums_bound = max(sums_bytes / PEAK_BYTES, sums_ops / PEAK_FP32) * 1e3
    sums_timing = dict(
        ms=sums_ms, wall_ms_per_launch=sums_wall_ms, plain_ms=plain_sums_ms, bound_ms=sums_bound,
        bound_by="bytes" if sums_bytes / PEAK_BYTES >= sums_ops / PEAK_FP32 else "operations",
        bytes=sums_bytes, ops=sums_ops, shape=[CAMPAIGN_B, T, P, L], max_abs_err=sums_err,
        library_ms=lib_sums_ms)
    emit("campaign", check="grid_tick_sums kernel timing", card=smi(),
         library="v @ cat([leg_proc, leg_link]) (cuBLAS, device time)", **sums_timing)
    by_run = {f"{r['mode']}_{r['params']}": r["launches"]["grid_tick"] for r in runs}
    sums_by_run = {f"{r['mode']}_{r['params']}": r["launches"]["grid_tick_sums"] for r in runs}
    return {"runs": runs, "timing": timing, "sums_timing": sums_timing, "launches_by_run": by_run,
            "sums_launches_by_run": sums_by_run, "profile": prof}


def phase_section5(dev) -> dict:
    """The calibration launcher (``repro_torch.launch.calibrate``) at its
    defaults on the Section-5 campaign: each stage's seconds between
    ``torch.cuda.synchronize()`` calls and its kernel launches (counts set
    to 0 just before it)."""
    stages = {}

    @contextlib.contextmanager
    def stage(name):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stages[name] = dict(seconds=time.perf_counter() - t0, launches=counts())

    out = os.path.join(ROOT, "build", "reports", "section5_calibration.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its report goes to the file
        report = calibrate_launcher.main(["--device", "cuda", "--out", out], stage=stage)
    wall = time.perf_counter() - t0
    for key in ("theta_star_marginal", "theta_map", "rhat", "x_true"):
        v = np.asarray(report[key], dtype=np.float64)
        if v.shape != (3,) or not np.isfinite(v).all():
            raise AssertionError(f"section5 {key} not finite [3]: {report[key]}")
    if not 0.0 < report["accept_rate"] < 1.0:
        raise AssertionError(f"section5 accept rate {report['accept_rate']}")
    for name, want in (("x_true", "grid_tick"), ("presimulate", "grid_tick"),
                       ("presimulate", "grid_tick_sums"), ("train", "selu_mlp"),
                       ("mcmc", "selu_mlp"), ("validate", "grid_tick"),
                       ("validate", "grid_tick_sums")):
        if stages[name]["launches"][want] <= 0:
            raise AssertionError(f"kernel {want} was not launched in stage {name}")
    res = dict(wall_s=wall, stages=stages, theta_true=report["theta_true"],
               x_true=report["x_true"], theta_star=report["theta_star_marginal"],
               theta_map=report["theta_map"], rhat=report["rhat"],
               accept_rate=report["accept_rate"],
               validation_mean_abs_error=report["validation_mean_abs_error"])
    emit("section5", **res)
    return res


def scheduler_grid():
    """tests/test_scheduler.py's grid (built here, from the port's modules):
    a WAN into the worker nodes loaded with background traffic, clear
    SE->SE and LAN links; 6 files, each read remotely or placed."""
    g = topology.Grid()
    g.add_data_center("SRC")
    g.add_data_center("DST")
    g.add_storage_element("seS", "SRC")
    g.add_storage_element("seD", "DST")
    for w in range(2):
        g.add_worker_node(f"wn{w}", "DST")
    for w in range(2):
        g.add_link("seS", f"wn{w}", 60.0, bg_mu=12.0, bg_sigma=1.0)
        g.add_link("seD", f"wn{w}", 400.0)
    g.add_link("seS", "seD", 500.0)
    accesses = []
    rng = np.random.RandomState(0)
    for j in range(2):
        for _ in range(3):
            size = float(rng.uniform(100.0, 400.0))
            remote = workload.FileAccess(workload.Replica(size, "seS"),
                                         workload.AccessProfileKind.REMOTE, "webdav")
            placed = workload.FileAccess(workload.Replica(size, "seS"),
                                         workload.AccessProfileKind.DATA_PLACEMENT, "gsiftp",
                                         local_storage_element="seD")
            accesses.append(scheduler.CandidateAccess(job=j, candidates=(remote, placed)))
    return g, accesses


def run_optimize(where) -> dict:
    """``optimize_profiles`` (population 32, 12 generations) on the
    congested grid on ``where``, with its kernels' launches, and the
    all-remote assignment's fitness (``_fitness``: one per-campaign
    simulation, its ``grid_tick`` launches counted apart)."""
    g, acc = scheduler_grid()
    st = scheduler.build_super_table(g, ["wn0", "wn1"], acc, max_ticks=60_000, device=where)
    base = engine.make_params(st.table, device=where)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    best, f_best, hist = scheduler.optimize_profiles(st, base, prng.PRNGKey(1), population=32,
                                                     generations=12)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    reset_counts()
    f_remote = float(scheduler._fitness(st, base, torch.zeros(st.n_access, dtype=torch.int64),
                                        prng.PRNGKey(0)))
    return dict(wall_s=wall, best=best.tolist(), best_fitness=f_best, all_remote_fitness=f_remote,
                history=hist, launches=launches, fitness_launches=counts())


def phase_optimize(dev) -> dict:
    """The optimizer on the card: its best fitness no worse than the
    all-remote assignment's, its history equal to the CPU path's, the bank
    kernels launched by the population runs and the per-campaign kernel by
    the single-assignment fitness."""
    card = run_optimize(dev)
    cpu = run_optimize(torch.device("cpu"))
    if card["history"] != cpu["history"] or card["best"] != cpu["best"]:
        raise AssertionError(f"optimize card {card['history']} vs CPU {cpu['history']}")
    if not card["best_fitness"] <= card["all_remote_fitness"]:
        raise AssertionError(f"best fitness {card['best_fitness']} worse than all-remote "
                             f"{card['all_remote_fitness']}")
    if card["launches"]["grid_tick_bank_fused"] <= 0 or card["fitness_launches"]["grid_tick"] <= 0:
        raise AssertionError(f"optimize launches {card['launches']}, {card['fitness_launches']}")
    emit("optimize", population=32, generations=12, card=card, cpu_wall_s=cpu["wall_s"],
         history_equal_cpu=True)
    return card


# ---------------------------------------------------------------------------
# the LLM substrate's serving path (hymba-1.5b)
# ---------------------------------------------------------------------------
HYMBA = "hymba-1.5b"
QWEN_MOE = "qwen2-moe-a2.7b"
SEAMLESS, INTERNVL = "seamless-m4t-large-v2", "internvl2-2b"
# the dense configs at head dim 128: their attention shapes in llm_kernels
DENSE_D128 = ("qwen2.5-14b", "minitron-8b", "gemma3-27b")
LLM_B, LLM_S, LLM_NEW = 8, 2048, 64
# kernel vs plain, relative to max|plain|: both sum in float32 in another
# order (online vs full softmax, chunked recurrence vs its plain replay);
# in bf16 each side also rounds its output once (2^-8 a step), so two steps
LLM_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
MLSTM_TOL_F32 = 1e-4  # the cell's exponentials amplify the sums' rounding
# flash in bf16, each query row's error relative to that row's own max|plain|:
# both sides' float32 sums agree far inside a bf16 step, so each output
# rounds the same way or one step apart, at most 2^-7 of the row's largest
# entry; two steps. (max|plain| over the whole tensor comes from early rows,
# which average few keys; later rows are ~sqrt(1/n) as large.)
FLASH_ROW_TOL_BF16 = 2.0 ** -6
# float32 logits of one model by two paths (decode against prefill on the
# card; the card against the CPU path), relative to max|logits|: the same
# sums in other orders (cuBLAS and the kernels against MKL and the plain
# versions, flash against decode attention) over up to 32 layers of widths
# up to 6,400
SERVE_F32_TOL = 2e-3
# bf16 logits of decode against bf16 prefill, relative to max|logits|: the
# two paths round activations to bf16 at other places, over 32 layers of
# random weights. Set from the card's readings (5.5% and 6.2%, PERF.md); the
# float32 check above is the one that holds the kernels to each other.
SERVE_BF16_TOL = 0.10
# the bf16 prefill's drift from float32 (max|logits| share) measured with
# the float32 CUDA-core forward kernel on bf16 values (PERF.md),
# printed beside this run's: the tensor-core forward rounds p to bf16
# before P V
BF16_PREFILL_DRIFT_CUDA_CORE = 0.127


def rel_err(name, got, want, tol) -> float:
    """``max|got - want| / max|want|``; raises past ``tol``."""
    scale = max(float(want.double().abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max()) / scale
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} of max|plain| {scale}, past {tol}")
    return err


def row_rel_err(got, want) -> float:
    """The largest over query rows (all but the last dim) of ``max|got -
    want| / max|want|`` within the row; a row whose plain output is all 0
    (it keeps no key) counts its absolute error."""
    g, w = got.double(), want.double()
    scale, diff = w.abs().amax(-1), (g - w).abs().amax(-1)
    return float(torch.where(scale > 0, diff / scale.clamp_min(1e-300), diff).max())


# flash's ragged cases, (label, (B, Sq, Skv, Hq, Hkv, D), kwargs): GQA, a
# window, a q_offset, S off the 64-row tile, non-causal, rows with no key (a
# window shorter than the gap q_offset leaves), alone and beside rows that
# keep some in one 64-row tile, an odd head dim
FLASH_CASES = (
    ("gqa", (2, 100, 100, 6, 2, 64), dict()),
    ("window", (2, 130, 130, 4, 4, 32), dict(window=17)),
    ("q_offset", (1, 40, 90, 6, 3, 20), dict(window=24, q_offset=50)),
    ("non_causal", (2, 77, 50, 2, 1, 48), dict(causal=False)),
    ("dead_rows", (1, 30, 20, 2, 2, 16), dict(window=4, q_offset=40)),
    ("mixed_dead_rows", (1, 30, 20, 2, 2, 16), dict(window=8, q_offset=10)),
    ("odd_d", (2, 70, 70, 4, 2, 17), dict()),
)


# the same cases past D 64, on the forward's width-128 instances: D 128
# (GQA groups 5 and 2, qwen2-moe's group 1), D 96 (cp.async staging of 12
# of 16 chunks) and D 77 (off a multiple of 8: plain loads)
FLASH_D128_CASES = (
    ("D128 gqa", (2, 100, 100, 10, 2, 128), dict()),
    ("D128 window", (2, 130, 130, 4, 4, 128), dict(window=17)),
    ("D128 q_offset", (1, 40, 90, 6, 3, 128), dict(window=24, q_offset=50)),
    ("D128 non_causal", (2, 77, 50, 4, 2, 128), dict(causal=False)),
    ("D128 dead_rows", (1, 30, 20, 2, 2, 128), dict(window=4, q_offset=40)),
    ("D128 mixed_dead_rows", (1, 30, 20, 2, 2, 128), dict(window=8, q_offset=10)),
    ("D96", (2, 70, 70, 4, 2, 96), dict()),
    ("D77", (2, 70, 70, 4, 1, 77), dict(window=9)),
)


def flash_case(B, Sq, Skv, Hq, Hkv, D, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((B, S, H, D), generator=g).to(dev).to(dtype)
                 for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))


def unaligned(x):
    """``x`` copied into a contiguous view 2 or 4 bytes past a 16-byte
    boundary (a head dim's pointers off cp.async's alignment)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def check_flash(label, q, k, v, dtype, phase="llm_kernels", **kw) -> float:
    out, lse = flash_attention.flash_attention_cuda(q, k, v, **kw)
    want, want_lse = ref.flash_attention(q, k, v, **kw)
    err = rel_err(f"flash {label}", out, want, LLM_TOL[dtype])
    row_err = row_rel_err(out, want)
    if dtype == torch.bfloat16 and not row_err <= FLASH_ROW_TOL_BF16:
        raise AssertionError(f"flash {label}: a row's max abs err is {row_err} of its "
                             f"max|plain|, past {FLASH_ROW_TOL_BF16}")
    if not torch.equal(torch.isinf(lse), torch.isinf(want_lse)):
        raise AssertionError(f"flash {label}: lse is +inf on other rows than the plain version's")
    fin = torch.isfinite(want_lse)
    lse_err = 0.0
    if bool(fin.any()):
        lse_err = float((lse[fin] - want_lse[fin]).abs().max())
        if not lse_err <= 1e-4 * max(1.0, float(want_lse[fin].abs().max())):
            raise AssertionError(f"flash {label}: lse max abs err {lse_err}")
    emit(phase, kernel="flash_attention_fwd", case=label, dtype=str(dtype),
         shape=[list(q.shape), list(k.shape)], max_rel_err=err, tol=LLM_TOL[dtype],
         max_row_rel_err=row_err,
         row_tol=FLASH_ROW_TOL_BF16 if dtype == torch.bfloat16 else None,
         lse_max_abs_err=lse_err, dead_rows=int(torch.isinf(lse).sum()),
         live_rows=int(torch.isfinite(lse).sum()), **{k_: v_ for k_, v_ in kw.items()})
    return err


def mlstm_case(B, S, H, Dk, Dv, normalize, dtype, seed, dev):
    """q, k, v and float32 gates: xLSTM pre-activations, or SSD gates as
    hymba's mamba heads make them (log dt, -dt)."""
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn((B, S, H, Dk), generator=g).to(dev).to(dtype) for _ in range(2))
    v = torch.randn((B, S, H, Dv), generator=g).to(dev).to(dtype)
    if normalize:
        ig = torch.randn((B, S, H), generator=g)
        fg = torch.randn((B, S, H), generator=g) + 3.0
    else:
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g) - 2.0)
        ig, fg = torch.log(dt + 1e-9), -dt
    return q, k, v, ig.to(dev), fg.to(dev)


def mlstm_model_share(out, model) -> float:
    """The largest share of a tensor-core mLSTM kernel's limit against its
    rounding model (``ref.mlstm_chunk_tc``, the SSD kernel and, past Dk 64,
    the pair under either flag: the normaliser divides both sides' numerators
    by values taken in float32 from the same unrounded sums, so one limit
    serves both flags): elementwise, one bf16 step of
    the element (2^-7 of it: each side rounds its float32 result once, and
    a rounded S_intra, kw or C may land one step apart where the two
    float32 values straddle a rounding boundary) plus 2^-10 of max|model|
    (the float32 sums in another order, through such steps)."""
    g, m = out.double(), model.double()
    limit = 2.0 ** -7 * m.abs() + 2.0 ** -10 * float(m.abs().max())
    return float(((g - m).abs() / limit).max())


def check_mlstm(label, args, dtype, chunk, normalize, phase="llm_kernels", abs_errs=None) -> float:
    """The mLSTM kernel against ``ref.mlstm_chunk_chunked`` on the same
    inputs: its max relative error (returned) within MLSTM_TOL_F32 or
    LLM_TOL; ``abs_errs``, a list, gets the max absolute error."""
    out = mlstm_chunk.mlstm_chunk_cuda(*args, chunk=chunk, normalize=normalize)
    want = ref.mlstm_chunk_chunked(*args, chunk=chunk, normalize=normalize)
    tol = MLSTM_TOL_F32 if dtype == torch.float32 else LLM_TOL[dtype]
    err = rel_err(f"mlstm {label}", out, want, tol)
    abs_err = float((out.double() - want.double()).abs().max())
    if abs_errs is not None:
        abs_errs.append(abs_err)
    Dk = args[0].shape[-1]
    wide = mlstm_chunk.uses_wide(dtype, chunk, Dk)
    mma = wide or mlstm_chunk.uses_mma(dtype, normalize, chunk, Dk)
    extra = {}
    if mma:
        share = mlstm_model_share(out, ref.mlstm_chunk_tc(*args, chunk=chunk, normalize=normalize))
        if not share <= 1.0:
            raise AssertionError(f"mlstm {label}: {share} of the rounding model's limit")
        extra = dict(model_limit_share=share)
    kernel = ("mlstm_wide" if wide else
              "mlstm_chunk_tiled" if mlstm_chunk.uses_tiled(dtype, chunk, Dk) else "mlstm_chunk")
    emit(phase, kernel=kernel, case=label, dtype=str(dtype), normalize=normalize, chunk=chunk,
         q=list(args[0].shape), v=list(args[2].shape), max_rel_err=err, max_abs_err=abs_err,
         tol=tol, tensor_cores=mma, **extra)
    return err


def mlstm_ops(B, S, H, Dk, Dv, chunk) -> int:
    """Operations of the chunkwise cell: per chunk and (batch, head), the
    scores and their products with v over the causal half, the
    inter-chunk q C, the state update k^T v."""
    return B * H * -(-S // chunk) * 2 * (chunk * chunk // 2 * (Dk + Dv) + 2 * chunk * Dk * Dv)


def attention_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs the masks keep, per (batch, head)."""
    i = torch.arange(Sq, dtype=torch.int64)[:, None]
    j = torch.arange(Skv, dtype=torch.int64)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return int(keep.sum())


def bound(bytes_, ops_):
    """The least ms for ``bytes_`` at the memory rate or ``ops_`` at the
    bf16 tensor-core rate, and which of the two it is."""
    t_b, t_o = bytes_ / PEAK_BYTES, ops_ / PEAK_BF16
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_decode_repeats(label, out, q, kc, vc, lengths) -> None:
    """A second call of the decode kernel on the same inputs gives the same
    bits (its splits merge in split order)."""
    again = decode_attention.decode_attention_cuda(q, kc, vc, lengths)
    if not torch.equal(again, out):
        raise AssertionError(f"decode {label}: a second call differs from the first")


def phase_llm_kernels(dev) -> dict:
    """The three kernels against their plain versions on small ragged cases
    (float32 and bf16) and at hymba-1.5b's serving shapes (bf16), then timed
    at those shapes with CUDA events."""
    cfg = configs.get_config(HYMBA)
    errs = {"flash_attention_fwd": 0.0, "decode_attention": 0.0, "mlstm_chunk": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, kw in FLASH_CASES:
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], check_flash(
                label, *flash_case(*shape, dtype, seed=shape[1], dev=dev), dtype, **kw))
        # pointers off 16 bytes: the bf16 kernel stages its tiles by plain loads
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], check_flash(
            "unaligned", *(unaligned(x) for x in flash_case(2, 100, 100, 6, 2, 64, dtype, seed=3,
                                                              dev=dev)), dtype))
        # decode: ragged lengths, 1 and the full cache (and an empty one)
        g = torch.Generator().manual_seed(7)
        B, S, Hq, Hkv, D = 5, 300, 25, 5, 64
        q = torch.randn((B, Hq, D), generator=g).to(dev).to(dtype)
        kc, vc = (torch.randn((B, S, Hkv, D), generator=g).to(dev).to(dtype) for _ in range(2))
        lengths = torch.tensor([1, S, 0, 77, 250], dtype=torch.int32, device=dev)
        out = decode_attention.decode_attention_cuda(q, kc, vc, lengths)
        err = rel_err("decode ragged", out, ref.decode_attention(q, kc, vc, lengths), LLM_TOL[dtype])
        if float(out[2].abs().max()) != 0.0:
            raise AssertionError("decode: a sequence with no valid position is not 0")
        check_decode_repeats("ragged", out, q, kc, vc, lengths)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        emit("llm_kernels", kernel="decode_attention", case="ragged", dtype=str(dtype),
             lengths=lengths.tolist(), cache=[B, S, Hkv, D], max_rel_err=err,
             splits=decode_attention.splits(B, S, Hq, Hkv, D, dtype), repeats_bitwise=True)
        # hymba's 2,112-slot cache with ragged lengths: splits wholly past a length
        size = LLM_S + LLM_NEW
        kc, vc = (torch.randn((B, size, Hkv, D), generator=g).to(dev).to(dtype) for _ in range(2))
        lengths = torch.tensor([0, 1, 63, 64, size], dtype=torch.int32, device=dev)
        out = decode_attention.decode_attention_cuda(q, kc, vc, lengths)
        err = rel_err("decode ragged 2,112", out, ref.decode_attention(q, kc, vc, lengths),
                      LLM_TOL[dtype])
        if float(out[0].abs().max()) != 0.0:
            raise AssertionError("decode: a sequence with no valid position is not 0")
        check_decode_repeats("ragged 2,112", out, q, kc, vc, lengths)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        emit("llm_kernels", kernel="decode_attention", case="ragged 2,112", dtype=str(dtype),
             lengths=lengths.tolist(), cache=[B, size, Hkv, D], max_rel_err=err,
             splits=decode_attention.splits(B, size, Hq, Hkv, D, dtype), repeats_bitwise=True)
        # mLSTM: both flags, Dk != Dv, S off the chunk
        for normalize, S_, Dk, Dv, chunk in ((True, 150, 64, 64, 128), (True, 70, 24, 40, 16),
                                             (False, 300, 16, 128, 128), (False, 45, 8, 20, 32)):
            args = mlstm_case(2, S_, 3, Dk, Dv, normalize, dtype, seed=S_, dev=dev)
            errs["mlstm_chunk"] = max(errs["mlstm_chunk"], check_mlstm(
                f"S={S_} Dk={Dk} Dv={Dv}", args, dtype, chunk, normalize))

    # hymba-1.5b's serving shapes, bf16 (flash also on the same values in
    # float32, held to the float32 limit)
    bf = torch.bfloat16
    B, S, Hq, Hkv, D, W = LLM_B, LLM_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    q, k, v = flash_case(B, S, S, Hq, Hkv, D, bf, seed=11, dev=dev)
    res = {}
    flash_rows = {}
    for label, window in (("global", None), ("local", W)):
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], check_flash(
            f"main {label}", q, k, v, bf, window=window))
        check_flash(f"main {label}", *(x.float() for x in (q, k, v)), torch.float32,
                    window=window)
        flash_rows[label] = flash_timing(q, k, v, window)
        emit("llm_kernels", kernel="flash_attention_fwd", timing=label, card=smi(),
             shape=[B, S, Hq, Hkv, D], window=window,
             library="F.scaled_dot_product_attention(enable_gqa=True)", **flash_rows[label])
    res["flash_attention_fwd"] = dict(flash_rows["global"], local=flash_rows["local"])
    del q, k, v

    dec_rows = {}
    for label, size in (("global", S + LLM_NEW), ("ring", W)):
        dec_rows[label] = decode_timing(f"main {label}", B, size, Hq, Hkv, D, seed=size, dev=dev)
        errs["decode_attention"] = max(errs["decode_attention"], dec_rows[label]["max_rel_err"])
    res["decode_attention"] = dict(dec_rows["global"], ring=dec_rows["ring"])

    H, Dk, Dv, chunk = cfg.n_heads, cfg.ssm_state, cfg.ssm_expand * cfg.d_model // cfg.n_heads, 128
    args = mlstm_case(B, S, H, Dk, Dv, False, bf, seed=13, dev=dev)
    errs["mlstm_chunk"] = max(errs["mlstm_chunk"], check_mlstm("main SSD", args, bf, chunk, False))
    ssd = lambda: mlstm_chunk.mlstm_chunk_cuda(*args, chunk=chunk, normalize=False)
    ms, _ = timed(ssd, 20)
    dev_ms = device_ms(ssd, 20, "mlstm")
    plain_ms, _ = timed(lambda: ref.mlstm_chunk_chunked(*args, chunk=chunk, normalize=False), 2)
    ops_ = mlstm_ops(B, S, H, Dk, Dv, chunk)
    bytes_ = nbytes(*args) + args[2].numel() * args[2].element_size()
    b_ms, b_by = bound(bytes_, ops_)
    res["mlstm_chunk"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None, ops=ops_, bytes=bytes_)
    # the tensor-core kernel's grid: a block of 8 warps per (batch, head,
    # 128-wide Dv slice), its resident blocks an SM, waves, ptxas' registers
    occ = mlstm_chunk.mma_occupancy(Dk)
    blocks = B * H * -(-Dv // 128)
    slots = torch.cuda.get_device_properties(dev).multi_processor_count * occ["blocks_per_sm"]
    ptxas = {k_: v_ for k_, v_ in ptxas_by_kernel(_build.build_logs.get("mlstm_chunk", "")).items()
             if k_.startswith("mlstm_ssd_mma_kernel")}
    emit("llm_kernels", kernel="mlstm_chunk", timing="main SSD", card=smi(),
         shape=[B, S, H, Dk, Dv], chunk=chunk, kernel_name="mlstm_ssd_mma_kernel",
         tensor_cores=mlstm_chunk.uses_mma(bf, False, chunk, Dk), blocks=blocks, threads=256,
         blocks_per_sm=occ["blocks_per_sm"], smem_bytes=occ["smem_bytes"],
         waves=-(-blocks // slots), ptxas=ptxas,
         library="none: no single PyTorch call computes the chunkwise mLSTM / SSD cell",
         **res["mlstm_chunk"])
    for name, e in errs.items():
        res[name]["max_abs_err"] = e
    res.update(llm_kernels_d128(dev))
    res.update(llm_kernels_encdec(dev))
    torch.cuda.synchronize()
    return res


def flash_timing(q, k, v, window, causal=True) -> dict:
    """The bf16 forward at a shape (causal with Sq = Skv, or without a mask
    at any Sq, Skv; and ``window``), timed by CUDA events and under
    ``torch.profiler`` beside its bound, the plain version and SDPA (a band
    mask for a window)."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    kernel = lambda: flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    ms, _ = timed(kernel, 5)
    plain_ms, _ = timed(lambda: ref.flash_attention(q, k, v, causal=causal, window=window), 2)
    pairs = B * Hq * attention_pairs(Sq, Skv, causal, window)
    ops_ = 4 * D * pairs
    bytes_ = nbytes(q, k, v) + nbytes(q) + 4 * B * Hq * Sq
    b_ms, b_by = bound(bytes_, ops_)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        i = torch.arange(Sq, device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib_ms, _ = timed(lib, 10)
    return dict(ms=ms, device_ms=device_ms(kernel, 5, "flash_fwd"), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_device_ms=device_ms(lib, 5), ops=ops_, bytes=bytes_)


def decode_timing(label, B, size, Hq, Hkv, D, seed, dev) -> dict:
    """The bf16 decode kernel on a full cache of ``size`` slots: held to
    the plain version (and to itself on a second call), then timed beside
    its bound, the plain version and SDPA."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    qd = torch.randn((B, Hq, D), generator=g).to(dev).to(bf)
    kc, vc = (torch.randn((B, size, Hkv, D), generator=g).to(dev).to(bf) for _ in range(2))
    lengths = torch.full((B,), size, dtype=torch.int32, device=dev)
    out = decode_attention.decode_attention_cuda(qd, kc, vc, lengths)
    err = rel_err(f"decode {label}", out, ref.decode_attention(qd, kc, vc, lengths), LLM_TOL[bf])
    check_decode_repeats(label, out, qd, kc, vc, lengths)
    # the kernel (~0.02 ms) is faster than its host call: its time and
    # SDPA's are device time under the profiler, the calls' own wall per
    # call (CUDA events over a loop) beside them. A decode step reads each
    # layer's cache once, cold: the timed calls cycle through copies of the
    # cache that together pass the 50 MB L2 (the same cache again, L2-warm,
    # beside it)
    n_copies = -(-128 * 2 ** 20 // nbytes(kc, vc))
    copies = itertools.cycle([(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_copies)])
    kernel = lambda: decode_attention.decode_attention_cuda(qd, *next(copies), lengths)
    ms = device_ms(kernel, 200, "decode_kernel")
    warm_ms = device_ms(lambda: decode_attention.decode_attention_cuda(qd, kc, vc, lengths), 200,
                        "decode_kernel")
    call_ms, _ = timed(kernel, 200)
    plain_ms = device_ms(lambda: ref.decode_attention(qd, kc, vc, lengths), 5)
    bytes_ = nbytes(qd, kc, vc, lengths) + nbytes(qd)
    ops_ = 4 * D * B * Hq * size
    b_ms, b_by = bound(bytes_, ops_)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qd[:, :, None, :], *(x.transpose(1, 2) for x in next(copies)),
                       enable_gqa=True)
    lib_ms = device_ms(lib, 200)
    lib_warm_ms = device_ms(lambda: sdpa(qd[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
                                         enable_gqa=True), 200)
    lib_call_ms, _ = timed(lib, 200)
    del copies
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, bytes=bytes_, max_rel_err=err,
               ms_l2_warm=warm_ms, library_ms_l2_warm=lib_warm_ms,
               call_ms=call_ms, library_call_ms=lib_call_ms,
               clock="device time (torch.profiler), cache cold in L2")
    splits = decode_attention.splits(B, size, Hq, Hkv, D, bf)
    emit("llm_kernels", kernel="decode_attention", timing=label, card=smi(),
         cache=[B, size, Hkv, D], group=Hq // Hkv, splits=splits, blocks=B * Hkv * splits,
         repeats_bitwise=True,
         library="F.scaled_dot_product_attention(enable_gqa=True)", **row)
    return row


def llm_kernels_d128(dev) -> dict:
    """The flash forward's and decode attention's head dim 128 (the
    forward's width-128 instances): ragged cases, float32 and bf16, then
    qwen2-moe-a2.7b's serving shapes and the dense D = 128 configs'
    attention shapes (bf16), timed. Keys ``flash_attention_fwd_d128`` and
    ``decode_attention_d128``."""
    bf = torch.bfloat16
    moe = configs.get_config(QWEN_MOE)
    flash_err = dec_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, kw in FLASH_D128_CASES:
            flash_err = max(flash_err, check_flash(
                label, *flash_case(*shape, dtype, seed=shape[1] + shape[5], dev=dev), dtype, **kw))
        for label, shape in (("unaligned", (2, 100, 100, 6, 2, 128)),
                             ("unaligned odd_d", (1, 70, 70, 4, 2, 100))):
            flash_err = max(flash_err, check_flash(label, *(unaligned(x) for x in flash_case(
                *shape, dtype, seed=shape[5], dev=dev)), dtype))
        # decode: groups 1, 2, 4 and 5 on ragged lengths (0 and the full
        # cache among them), then qwen2-moe's 2,112-slot cache (16 / 16)
        g = torch.Generator().manual_seed(128)
        for G in (1, 2, 4, 5):
            dec_err = max(dec_err, check_decode_case(f"D128 G{G}", 5, 300, 2 * G, 2, 128,
                                                     [1, 300, 0, 77, 250], dtype, g, dev))
        size = LLM_S + LLM_NEW
        dec_err = max(dec_err, check_decode_case(
            f"D128 {QWEN_MOE} ragged", LLM_B, size, moe.n_heads, moe.n_kv_heads, moe.hd,
            [0, 1, 63, 64, 1000, size - 65, size - 1, size], dtype, g, dev))
    res = {}
    # qwen2-moe-a2.7b's prefill shape (16 / 16 heads, causal), bf16 and the
    # same values in float32; then the dense configs' (qwen2.5-14b 40 / 8,
    # minitron-8b 32 / 8, gemma3-27b's local layers 32 / 16 at the 1,024
    # window), bf16
    shapes = [(QWEN_MOE, moe.n_heads, moe.n_kv_heads, None)]
    shapes += [(a, c.n_heads, c.n_kv_heads, c.window) for a, c in
               ((a, configs.get_config(a)) for a in DENSE_D128)]
    rows = {}
    for arch, Hq, Hkv, window in shapes:
        q, k, v = flash_case(LLM_B, LLM_S, LLM_S, Hq, Hkv, 128, bf, seed=Hq + Hkv, dev=dev)
        flash_err = max(flash_err, check_flash(f"{arch} prefill", q, k, v, bf, window=window))
        if arch == QWEN_MOE:
            check_flash(f"{arch} prefill", *(x.float() for x in (q, k, v)), torch.float32)
        rows[arch] = flash_timing(q, k, v, window)
        emit("llm_kernels", kernel="flash_attention_fwd", timing=f"{arch} prefill", card=smi(),
             shape=[LLM_B, LLM_S, Hq, Hkv, 128], window=window, kernel_name="flash_fwd_mma_kernel",
             width=128, library="F.scaled_dot_product_attention(enable_gqa=True)", **rows[arch])
        del q, k, v
    res["flash_attention_fwd_d128"] = dict(rows[QWEN_MOE], max_abs_err=flash_err,
                                           **{a: rows[a] for a in DENSE_D128})
    drows = {}
    for arch, Hq, Hkv, _ in shapes:
        drows[arch] = decode_timing(f"{arch} decode", LLM_B, LLM_S + LLM_NEW, Hq, Hkv, 128,
                                    seed=Hq, dev=dev)
        dec_err = max(dec_err, drows[arch]["max_rel_err"])
    res["decode_attention_d128"] = dict(drows[QWEN_MOE], max_abs_err=dec_err,
                                        **{a: drows[a] for a in DENSE_D128})
    return res


def encdec_flash_shapes():
    """The flash forward's shapes on the encoder-decoder and vision paths,
    ``(label, (B, Sq, Skv, Hq, Hkv, D), causal)`` from the configs:
    seamless-m4t-large-v2's encoder (frames over frames), its
    cross-attention in prefill (the prompt over the frames) and in decode
    (one query row over the frames), all without a mask; internvl2-2b's
    causal self-attention (GQA 2 at D 128)."""
    sm, iv = configs.get_config(SEAMLESS), configs.get_config(INTERNVL)
    F, heads = sm.frontend_tokens, (sm.n_heads, sm.n_kv_heads, sm.hd)
    return (("seamless encoder", (LLM_B, F, F, *heads), False),
            ("seamless cross", (LLM_B, LLM_S, F, *heads), False),
            ("seamless decode cross", (LLM_B, 1, F, *heads), False),
            ("internvl2 prefill", (LLM_B, LLM_S, LLM_S, iv.n_heads, iv.n_kv_heads, iv.hd), True))


def llm_kernels_encdec(dev) -> dict:
    """The flash forward at the encoder-decoder's and the vision config's
    shapes, held to its plain version in bf16 and on the same values in
    float32, then timed in bf16 beside bound, plain and SDPA on the same
    call; decode attention likewise at both configs' 2,112-slot caches
    (:func:`decode_timing`). Keys ``flash_attention_fwd_encdec`` and
    ``decode_attention_encdec``: a row a shape by label, and
    ``max_abs_err`` (the largest bf16 relative error)."""
    bf = torch.bfloat16
    rows, err = {}, 0.0
    for label, shape, causal in encdec_flash_shapes():
        q, k, v = flash_case(*shape, bf, seed=shape[1] + shape[2], dev=dev)
        err = max(err, check_flash(label, q, k, v, bf, causal=causal))
        check_flash(label, *(x.float() for x in (q, k, v)), torch.float32, causal=causal)
        rows[label] = flash_timing(q, k, v, None, causal=causal)
        emit("llm_kernels", kernel="flash_attention_fwd", timing=label, card=smi(),
             shape=list(shape), causal=causal, width=64 if shape[5] <= 64 else 128,
             library="F.scaled_dot_product_attention(enable_gqa=True)", **rows[label])
        del q, k, v
    drows = {}
    for label, arch in (("seamless decode", SEAMLESS), ("internvl2 decode", INTERNVL)):
        c = configs.get_config(arch)
        drows[label] = decode_timing(label, LLM_B, LLM_S + LLM_NEW, c.n_heads, c.n_kv_heads,
                                     c.hd, seed=c.hd, dev=dev)
    derr = max(r["max_rel_err"] for r in drows.values())
    return {"flash_attention_fwd_encdec": dict(rows, max_abs_err=err),
            "decode_attention_encdec": dict(drows, max_abs_err=derr)}


def check_decode_case(label, B, S, Hq, Hkv, D, lengths, dtype, g, dev) -> float:
    """The decode kernel against the plain version on random q and cache
    and ``lengths``; a sequence of length 0 gets 0; a second call the same
    bits. Returns the max relative error."""
    q = torch.randn((B, Hq, D), generator=g).to(dev).to(dtype)
    kc, vc = (torch.randn((B, S, Hkv, D), generator=g).to(dev).to(dtype) for _ in range(2))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = decode_attention.decode_attention_cuda(q, kc, vc, lengths)
    err = rel_err(f"decode {label}", out, ref.decode_attention(q, kc, vc, lengths), LLM_TOL[dtype])
    if any(float(out[b].abs().max()) != 0.0 for b in range(B) if int(lengths[b]) == 0):
        raise AssertionError(f"decode {label}: a sequence with no valid position is not 0")
    check_decode_repeats(label, out, q, kc, vc, lengths)
    emit("llm_kernels", kernel="decode_attention", case=label, dtype=str(dtype),
         lengths=lengths.tolist(), cache=[B, S, Hkv, D], group=Hq // Hkv, max_rel_err=err,
         splits=decode_attention.splits(B, S, Hq, Hkv, D, dtype), repeats_bitwise=True)
    return err


def seeded_pair(cfg, dev, seed: int = 1):
    """``(card model, CPU model)`` with the same seeded random weights, drawn
    on the card (the host's generator takes seconds a billion numbers)."""
    card_net = llm.init_params(seed, cfg, device=dev)
    return card_net, copy.deepcopy(card_net).to("cpu")


def llm_counts() -> dict:
    out = {}
    for k in LLM_KERNELS:
        out.update(k.LAUNCHES)
    return out


def greedy_decode(step, net, cache, logits, n: int):
    """``n`` greedy serve steps from ``logits``; the last step's logits."""
    for _ in range(n):
        logits, cache = step(net, cache, logits.argmax(-1))
    return logits, cache


def decode_vs_prefill(cfg, net, tokens, s: int, dev, frontend=None):
    """The float32 logits of position ``s`` two ways: a prefill over the
    ``s + 1`` tokens, and a prefill over the first ``s`` then one decode
    step of the token at position ``s`` (with a vision prefix of ``n``
    embeddings, ``frontend``, that is token ``s - n``: the prefix shifts
    the prompt by ``n`` positions; an encoder-decoder's frames feed both
    prefills)."""
    b = tokens.shape[0]
    extra = {} if frontend is None else {"frontend_embeds": frontend}
    shift = frontend.shape[1] if frontend is not None and cfg.frontend == "vision" else 0
    full, _ = llm.make_prefill_step(cfg)(
        net, llm.init_cache(cfg, b, s + 1, device=dev), {"tokens": tokens, **extra})
    cache = llm.init_cache(cfg, b, s + 1, device=dev)
    _, cache = llm.make_prefill_step(cfg)(net, cache, {"tokens": tokens[:, :s], **extra})
    stepped, _ = llm.make_serve_step(cfg)(net, cache, tokens[:, s - shift])
    return full.float(), stepped.float()


def phase_llm_serve(dev) -> dict:
    """hymba-1.5b at full width on the card: prefill 8 x 2,048 tokens, 64
    greedy decode steps, each run's kernel launches counted from 0; device
    time by kernel; decode against prefill; the card against the CPU path."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(HYMBA)
    B, S, N = LLM_B, LLM_S, LLM_NEW
    t0 = time.perf_counter()
    net = llm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    prefill, step = llm.make_prefill_step(cfg), llm.make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    batch = {"tokens": tokens[:, :S]}

    # warm-up (libraries loaded, cuBLAS handles made), then the timed run
    logits, cache = prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)
    greedy_decode(step, net, cache, logits, 2)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = llm.init_cache(cfg, B, S + N, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(net, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_run = {"prefill": llm_counts()}
    first = logits.argmax(-1)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = greedy_decode(step, net, cache, logits, N)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    by_run["decode"] = llm_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"serve logits not finite [{B}, {cfg.vocab_size}]")
    if cache["pos"] != S + N:
        raise AssertionError(f"cache pos {cache['pos']} after {S} + {N} tokens")
    zero = {k_: 0 for k_ in llm_counts()}
    want = {"prefill": {**zero, "flash_attention_fwd": cfg.n_layers, "mlstm_chunk": cfg.n_layers},
            "decode": {**zero, "decode_attention": cfg.n_layers * N}}
    if by_run != want:
        raise AssertionError(f"launches {by_run}, expected {want}")
    # the parameters require grad; serving must record no autograd graph
    graph = [t for t in (logits, *(x for c in cache["layers"] for d in c.values()
                                   for x in d.values())) if t.requires_grad]
    if not all(p.requires_grad for p in net.parameters()) or graph:
        raise AssertionError(f"serving recorded an autograd graph on {len(graph)} outputs")
    run = dict(layers=cfg.n_layers, params=n_params, batch=B, prompt=S, new_tokens=N,
               init_s=init_s, prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s,
               decode_s=decode_s, decode_ms_per_step=decode_s / N * 1e3,
               decode_tokens_per_s=B * N / decode_s, peak_memory_gb=peak / 1e9,
               launches_by_run=by_run, first_tokens=first.tolist())
    emit("llm_serve", card=smi(), **run)

    # device time by kernel of one prefill and one decode step, and the
    # device's busy share of their unprofiled wall
    prof = {}
    for label, fn, wall in (
        ("prefill", lambda: prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch),
         prefill_s),
        ("decode_step", lambda: step(net, cache, logits.argmax(-1)), decode_s / N),
    ):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:  # device events alone
            fn()
            torch.cuda.synchronize()
        rows = device_rows(pr)
        dev_s = sum(r[1] for r in rows) / 1e6
        kern = lambda tag: sum(r[1] for r in rows if tag in r[0]) / 1e6
        prof[label] = dict(
            device_s=dev_s, wall_s=wall, busy_share=dev_s / wall,
            flash_s=kern("flash_fwd"), decode_attention_s=kern("decode_kernel"),
            mlstm_s=kern("mlstm"), mlstm_share=kern("mlstm") / dev_s,
            device_launches=sum(r[2] for r in rows),
            top=[[k_[:70], us / 1e6, n] for k_, us, n in rows[:10]])
        emit("llm_serve", profile=label, **prof[label])
    run["profile"] = prof

    # 1. decode against prefill on the card: prefill over S + 1 tokens
    #    against prefill over S and one decode step of token S, 2 prompts.
    #    In float32 (the same weights, upcast) only the sums' order differs;
    #    in bf16 the two paths also round activations at other places
    del cache
    B1 = 2
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    net32 = copy.deepcopy(net).float()
    full32, step32 = decode_vs_prefill(cfg32, net32, tokens[:B1], S, dev)
    del net32
    err32 = rel_err("decode vs prefill (float32)", step32, full32, SERVE_F32_TOL)
    full16, step16 = decode_vs_prefill(cfg, net, tokens[:B1], S, dev)
    scale = float(full32.abs().max())
    noise = float((full16 - full32).abs().max()) / scale
    err16 = rel_err("decode vs prefill (bf16)", step16, full16, SERVE_BF16_TOL)
    emit("llm_serve", check="decode vs prefill on the card", tokens=S + 1, batch=B1,
         float32_max_rel_err=err32, float32_tol=SERVE_F32_TOL,
         bf16_prefill_vs_float32=noise,
         bf16_prefill_vs_float32_cuda_core_forward=BF16_PREFILL_DRIFT_CUDA_CORE,
         bf16_decode_vs_float32=float((step16 - full32).abs().max()) / scale,
         bf16_decode_vs_bf16_prefill=err16, bf16_tol=SERVE_BF16_TOL,
         argmax_agreement_bf16=float((step16.argmax(-1) == full16.argmax(-1)).float().mean()))
    run["decode_vs_prefill"] = err32
    run["decode_vs_prefill_bf16"] = err16
    del net

    # 2. the card against the CPU path in float32: one pattern unit (8
    #    layers, 1 global and 7 local), 2 x 1,280 tokens (past the window),
    #    then 8 decode steps, the same tokens on both sides
    cfg8 = dataclasses.replace(cfg, n_layers=cfg.pattern_len, dtype="float32")
    card_net, cpu_net = seeded_pair(cfg8, dev)
    B2, S2, steps = 2, 1280, 8
    toks = torch.randint(0, cfg.vocab_size, (B2, S2 + steps),
                         generator=torch.Generator().manual_seed(2))
    errs = []
    nets = ((card_net, llm.init_cache(cfg8, B2, S2 + steps, device=dev)),
            (cpu_net, llm.init_cache(cfg8, B2, S2 + steps, device="cpu")))
    outs = [llm.make_prefill_step(cfg8)(n_, c_, {"tokens": toks[:, :S2].to(c_["layers"][0]["kv"]["k"].device)})
            for n_, c_ in nets]
    errs.append(rel_err("card vs CPU prefill", outs[0][0].cpu(), outs[1][0], SERVE_F32_TOL))
    step8 = llm.make_serve_step(cfg8)
    caches = [o[1] for o in outs]
    for i in range(steps):
        got, caches[0] = step8(card_net, caches[0], toks[:, S2 + i].to(dev))
        want_, caches[1] = step8(cpu_net, caches[1], toks[:, S2 + i])
        errs.append(rel_err(f"card vs CPU step {i}", got.cpu(), want_, SERVE_F32_TOL))
    emit("llm_serve", check="card vs CPU path, float32", layers=cfg8.n_layers, batch=B2,
         prompt=S2, steps=steps, max_rel_err_by_step=errs, tol=SERVE_F32_TOL)
    run["card_vs_cpu"] = max(errs)
    torch.cuda.synchronize()
    return run


# ---------------------------------------------------------------------------
# xlstm-350m's serving path: the mLSTM on the tensor-core pair past Dk 64
# (float32 on the Dk-tiled kernel), the sLSTM's loop in torch ops
# ---------------------------------------------------------------------------
XLSTM = "xlstm-350m"
# past Dk 64 against ref.mlstm_chunk_chunked: (normalize, S, H, Dk, Dv), S
# off the 128-chunk (a padded last chunk); float32 runs the Dk-tiled kernel,
# bf16 the tensor-core pair
TILED_CASES = ((True, 150, 3, 80, 96), (False, 150, 3, 80, 96),
               (True, 300, 2, 512, 512), (False, 300, 2, 512, 512))
# the pair alone, bf16 (normalize, S, H, Dk, Dv, chunk): element staging (Dk
# 100, Dv 33) at 16-chunks; Dk 128 at 64-chunks; and off the multiple of 16,
# the case that stays on the Dk-tiled kernel in bf16
WIDE_CASES = ((True, 70, 3, 100, 33, 16), (True, 200, 2, 128, 64, 64))
TILED_BF16_CASE = (True, 150, 3, 80, 96, 120)
# a float32 xLSTM at full width, one mLSTM and one sLSTM layer: prompt and
# decode steps of the card against the CPU path
XLSTM_CHECK_B, XLSTM_CHECK_S, XLSTM_CHECK_STEPS = 2, 256, 8


@contextlib.contextmanager
def slstm_timed():
    """Inside, every ``SLSTM.prefill`` is timed on the host clock between two
    synchronisations; yields the list its seconds go to."""
    from repro_torch.models.blocks import SLSTM

    spent, orig = [], SLSTM.prefill

    def timed_prefill(self, x):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(self, x)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    SLSTM.prefill = timed_prefill
    try:
        yield spent
    finally:
        SLSTM.prefill = orig


def layer_decode_vs_prefill(net, tokens, s: int) -> list:
    """For each layer of an xLSTM ``net``, on the same inputs (the hidden
    states of a prefill over ``tokens [b, s + 1]``): the max relative error
    of its cell's output at position ``s`` by a decode step after a prefill
    over the first ``s`` positions, against its prefill over all ``s + 1``;
    raises past SERVE_F32_TOL."""
    cfg = net.cfg
    errs = []
    with torch.no_grad():
        x = net.embed[tokens]
        for i, layer in enumerate(net.layers):
            h = rms_norm(x, layer.norm1, cfg.norm_eps)
            y_full, _ = layer.cell.prefill(h)
            _, state = layer.cell.prefill(h[:, :s])
            y_step, _ = layer.cell.decode(h[:, s], state)
            errs.append(rel_err(f"xlstm layer {i} ({layer.kind}) decode vs prefill",
                                y_step.float(), y_full[:, s].float(), SERVE_F32_TOL))
            x = x + y_full
    return errs


def phase_llm_xlstm(dev) -> dict:
    """xlstm-350m's serving path on the card: (1) past Dk 64, the tensor-core
    pair (bf16) and the Dk-tiled kernel (float32) against their plain
    version (Dk 80 and 512, both flags, padded last chunks), the pair also
    against its rounding model, each timed at the prefill's shape beside
    its bound; (2) a float32 xLSTM of one mLSTM and one sLSTM layer at full
    width, the card against the CPU path (launches counted); (3) xlstm-350m
    at full width in bf16: prefill 8 x 2,048 tokens and 64 greedy decode
    steps, launches counted from 0 a run, the sLSTM loop's share of the
    prefill, device busy share; (4) decode against prefill, float32 and
    bf16."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(XLSTM)
    res = {}
    bf = torch.bfloat16
    # 1. the kernels
    errs = {"wide": [], "tiled": []}
    abs_errs = {"wide": [], "tiled": []}
    cases = [(dtype, normalize, S_, H_, Dk, Dv, 128) for dtype in (torch.float32, bf)
             for normalize, S_, H_, Dk, Dv in TILED_CASES]
    cases += [(bf, *c) for c in WIDE_CASES] + [(bf, *TILED_BF16_CASE)]
    for dtype, normalize, S_, H_, Dk, Dv, ch in cases:
        route = "wide" if mlstm_chunk.uses_wide(dtype, ch, Dk) else "tiled"
        if route == "tiled" and not mlstm_chunk.uses_tiled(dtype, ch, Dk):
            raise AssertionError(f"mlstm Dk {Dk} chunk {ch} {dtype}: neither route past Dk 64")
        args = mlstm_case(2, S_, H_, Dk, Dv, normalize, dtype, seed=S_ + Dk, dev=dev)
        before = dict(mlstm_chunk.LAUNCHES)
        errs[route].append(check_mlstm(f"S={S_} Dk={Dk} Dv={Dv} chunk={ch}", args, dtype, ch,
                                       normalize, phase="llm_xlstm", abs_errs=abs_errs[route]))
        ran = {k_: n - before[k_] for k_, n in mlstm_chunk.LAUNCHES.items() if n != before[k_]}
        want = ({"mlstm_wide_state": 1, "mlstm_wide_out": 1} if route == "wide"
                else {"mlstm_chunk_tiled": 1})
        if ran != want:
            raise AssertionError(f"mlstm Dk {Dk} chunk {ch} {dtype}: launches {ran}, expected {want}")
    B, S, N = LLM_B, LLM_S, LLM_NEW
    H, chunk = cfg.n_heads, 128
    Dk = Dv = cfg.ssm_expand * cfg.d_model // H
    n_ch = -(-S // chunk)
    ops_ = mlstm_ops(B, S, H, Dk, Dv, chunk)
    build_log = ptxas_by_kernel(_build.build_logs.get("mlstm_chunk", ""))
    sass = sass_counts("mlstm_chunk")
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    # the pair at the prefill's shape (bf16)
    args = mlstm_case(B, S, H, Dk, Dv, True, bf, seed=17, dev=dev)
    errs["wide"].append(check_mlstm("main mLSTM", args, bf, chunk, True, phase="llm_xlstm",
                                    abs_errs=abs_errs["wide"]))
    cell = lambda: mlstm_chunk.mlstm_chunk_cuda(*args, chunk=chunk, normalize=True)
    ms, _ = timed(cell, 10)
    plain_ms, _ = timed(lambda: ref.mlstm_chunk_chunked(*args, chunk=chunk, normalize=True), 2)
    b_ms, b_by = bound(nbytes(*args) + nbytes(args[2]), ops_)
    occ = mlstm_chunk.wide_occupancy()
    n_sl = -(-Dv // 64)
    z_bytes = B * S * H * Dv * 4
    side_bytes = (4 + n_sl) * B * H * n_ch * chunk * 4  # the gates' record and q . n shares
    # each kernel's own work: the state kernel reads q, k, v and the gates
    # and writes z and the record; its products q C and kw^T V over every
    # chunk's positions. The out kernel reads q, k, v, z and the record and
    # writes out; its products the causal scores and S V
    work = {
        "mlstm_wide_state": (nbytes(*args) + z_bytes + side_bytes,
                             2 * 2 * B * H * n_ch * chunk * Dk * Dv, B * H * n_sl),
        "mlstm_wide_out": (nbytes(*args[:3]) + z_bytes + side_bytes + nbytes(args[2]),
                           2 * B * H * n_ch * chunk * (chunk + 1) // 2 * (Dk + Dv), B * H * n_ch),
    }
    kernels = {}
    for name, (bytes_k, ops_k, blocks) in work.items():
        kname = f"{name}_kernel"
        kb_ms, kb_by = bound(bytes_k, ops_k)
        kernels[name] = dict(
            kernel_name=kname, device_ms=device_ms(cell, 5, name), bound_ms=kb_ms, bound_by=kb_by,
            ops=ops_k, bytes=bytes_k, blocks=blocks, blocks_per_sm=occ[kname]["blocks_per_sm"],
            smem_bytes=occ[kname]["smem_bytes"],
            waves=blocks / (slots * occ[kname]["blocks_per_sm"]),
            ptxas=build_log.get(kname), sass=sass.get(kname) or "not measured (no cuobjdump)")
        if sass and not sass.get(kname, {}).get("HMMA"):
            raise AssertionError(f"{kname}: no HMMA in its SASS {sass.get(kname)}")
    res["wide"] = dict(ms=ms, device_ms=sum(k_["device_ms"] for k_ in kernels.values()),
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       float32_cuda_core_floor_ms=ops_ / PEAK_FP32 * 1e3, library_ms=None,
                       ops=ops_, max_rel_err=max(errs["wide"]),
                       max_abs_err=max(abs_errs["wide"]), kernels=kernels)
    emit("llm_xlstm", kernel="mlstm_wide", timing="main mLSTM", card=smi(),
         shape=[B, S, H, Dk, Dv], chunk=chunk, threads={"mlstm_wide_state_kernel": 512,
                                                        "mlstm_wide_out_kernel": 256},
         library="none: no single PyTorch call computes the chunkwise mLSTM cell",
         **res["wide"])
    del args
    # the Dk-tiled kernel at the prefill's shape (float32, its route there)
    f32 = torch.float32
    args = mlstm_case(B, S, H, Dk, Dv, True, f32, seed=17, dev=dev)
    cell = lambda: mlstm_chunk.mlstm_chunk_cuda(*args, chunk=chunk, normalize=True)
    errs["tiled"].append(check_mlstm("main mLSTM float32", args, f32, chunk, True,
                                     phase="llm_xlstm", abs_errs=abs_errs["tiled"]))
    ms, _ = timed(cell, 5)
    dev_ms = device_ms(cell, 3, "mlstm_chunk_tiled")
    plain_ms, _ = timed(lambda: ref.mlstm_chunk_chunked(*args, chunk=chunk, normalize=True), 2)
    bytes_ = nbytes(*args) + nbytes(args[2])
    t_ms, t_by = max((bytes_ / PEAK_BYTES * 1e3, "bytes"), (ops_ / PEAK_FP32 * 1e3, "operations"))
    occ = mlstm_chunk.tiled_occupancy(Dk, f32)
    blocks = B * H * -(-Dv // 32)
    res["tiled"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=t_ms, bound_by=t_by,
                        library_ms=None, ops=ops_, bytes=bytes_, max_rel_err=max(errs["tiled"]),
                        max_abs_err=max(abs_errs["tiled"]))
    emit("llm_xlstm", kernel="mlstm_chunk_tiled", timing="main mLSTM float32", card=smi(),
         shape=[B, S, H, Dk, Dv], chunk=chunk, kernel_name="mlstm_chunk_tiled_kernel",
         blocks=blocks, threads=256, blocks_per_sm=occ["blocks_per_sm"],
         smem_bytes=occ["smem_bytes"], waves=blocks / (slots * occ["blocks_per_sm"]),
         ptxas={k_: v_ for k_, v_ in build_log.items() if k_.startswith("mlstm_chunk_tiled")},
         sass=sass.get("mlstm_chunk_tiled_kernel") or "not measured (no cuobjdump)",
         bound_note="float32 on the CUDA cores: operations at 67 TFLOP/s", **res["tiled"])
    del args

    # 2. float32, one mLSTM and one sLSTM layer at full width: the card
    #    against the CPU path, logits and every cache leaf
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               block_pattern=(BlockKind.MLSTM, BlockKind.SLSTM))
    card_net, cpu_net = seeded_pair(cfg2, dev)
    B2, S2, steps = XLSTM_CHECK_B, XLSTM_CHECK_S, XLSTM_CHECK_STEPS
    toks = torch.randint(0, cfg.vocab_size, (B2, S2 + steps),
                         generator=torch.Generator().manual_seed(5))
    caches = [llm.init_cache(cfg2, B2, S2 + steps, device=dev),
              llm.init_cache(cfg2, B2, S2 + steps, device="cpu")]
    prefill2, step2 = llm.make_prefill_step(cfg2), llm.make_serve_step(cfg2)
    reset_counts()
    got, caches[0] = prefill2(card_net, caches[0], {"tokens": toks[:, :S2].to(dev)})
    want, caches[1] = prefill2(cpu_net, caches[1], {"tokens": toks[:, :S2]})
    logit_errs = [rel_err("xlstm card vs CPU prefill", got.cpu(), want, SERVE_F32_TOL)]
    cache_errs = {}
    for i in range(steps + 1):
        for l_, (cg, cc) in enumerate(zip(caches[0]["layers"], caches[1]["layers"])):
            for name, t in cc["cell"].items():
                key = f"layer{l_}.{name}"
                cache_errs[key] = max(cache_errs.get(key, 0.0), rel_err(
                    f"xlstm card vs CPU cache {key} after {i} steps", cg["cell"][name].cpu(), t,
                    SERVE_F32_TOL))
        if i == steps:
            break
        got, caches[0] = step2(card_net, caches[0], toks[:, S2 + i].to(dev))
        want, caches[1] = step2(cpu_net, caches[1], toks[:, S2 + i])
        logit_errs.append(rel_err(f"xlstm card vs CPU step {i}", got.cpu(), want, SERVE_F32_TOL))
    # float32 runs the Dk-tiled kernel: one launch, the prefill's mLSTM layer
    res["float32_launches"] = llm_counts()
    want_f32 = {**{k_: 0 for k_ in llm_counts()}, "mlstm_chunk_tiled": 1}
    if res["float32_launches"] != want_f32:
        raise AssertionError(f"xlstm float32 launches {res['float32_launches']}, expected {want_f32}")
    emit("llm_xlstm", check="card vs CPU path, float32", layers=list(cfg2.layer_kinds),
         batch=B2, prompt=S2, steps=steps, max_rel_err_by_step=logit_errs,
         cache_max_rel_err=cache_errs, tol=SERVE_F32_TOL, launches=res["float32_launches"])
    res["card_vs_cpu"] = max(logit_errs + list(cache_errs.values()))
    del cpu_net, card_net, caches

    # 3. xlstm-350m at full width, bf16
    t0 = time.perf_counter()
    net = llm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    prefill, step = llm.make_prefill_step(cfg), llm.make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    batch = {"tokens": tokens[:, :S]}
    logits, cache = prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)  # warm-up
    greedy_decode(step, net, cache, logits, 2)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = llm.init_cache(cfg, B, S + N, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(net, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_run = {"prefill": llm_counts()}
    first = logits.argmax(-1)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = greedy_decode(step, net, cache, logits, N)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    by_run["decode"] = llm_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"xlstm serve logits not finite [{B}, {cfg.vocab_size}]")
    if cache["pos"] != S + N:
        raise AssertionError(f"xlstm cache pos {cache['pos']} after {S} + {N} tokens")
    kinds = collections.Counter(cfg.layer_kinds)
    zero = {k_: 0 for k_ in llm_counts()}
    want = {"prefill": {**zero, "mlstm_wide_state": kinds[BlockKind.MLSTM],
                        "mlstm_wide_out": kinds[BlockKind.MLSTM]}, "decode": zero}
    if by_run != want:
        raise AssertionError(f"xlstm launches {by_run}, expected {want}")
    graph = [t for t in (logits, *(x for c in cache["layers"] for d in c.values()
                                   for x in d.values())) if t.requires_grad]
    if graph:
        raise AssertionError(f"xlstm serving recorded an autograd graph on {len(graph)} outputs")
    # the sLSTM layers' loops timed alone inside a second prefill
    with slstm_timed() as spent:
        t0 = time.perf_counter()
        prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)
        torch.cuda.synchronize()
        timed_prefill_s = time.perf_counter() - t0
    run = dict(layers=cfg.n_layers, kinds=dict(kinds), params=n_params, batch=B, prompt=S,
               new_tokens=N, init_s=init_s, prefill_s=prefill_s,
               prefill_tokens_per_s=B * S / prefill_s, decode_s=decode_s,
               decode_ms_per_step=decode_s / N * 1e3, decode_tokens_per_s=B * N / decode_s,
               peak_memory_gb=peak / 1e9, launches_by_run=by_run, first_tokens=first.tolist(),
               slstm_loop_s=spent, slstm_share_of_prefill=sum(spent) / timed_prefill_s,
               prefill_s_with_slstm_syncs=timed_prefill_s)
    emit("llm_xlstm", card=smi(), **{k_: v_ for k_, v_ in run.items()})
    # device time by kernel of one prefill and one decode step (device
    # events only), beside the unprofiled walls
    prof = {}
    for label, fn, wall in (
        ("prefill", lambda: prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch),
         prefill_s),
        ("decode_step", lambda: step(net, cache, logits.argmax(-1)), decode_s / N),
    ):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            fn()
            torch.cuda.synchronize()
        rows = device_rows(pr)
        dev_s = sum(r[1] for r in rows) / 1e6
        wide_s = sum(r[1] for r in rows if "mlstm_wide" in r[0]) / 1e6
        prof[label] = dict(device_s=dev_s, wall_s=wall, busy_share=dev_s / wall,
                           mlstm_wide_s=wide_s, mlstm_wide_share_of_device=wide_s / dev_s,
                           device_launches=sum(r[2] for r in rows),
                           top=[[k_[:70], us / 1e6, n] for k_, us, n in rows[:10]])
        emit("llm_xlstm", profile=label, **prof[label])
    run["profile"] = prof
    del cache

    # 4. decode against prefill, 2 prompts. (a) Layer by layer in float32
    #    (the same weights, upcast), each layer on the same inputs (the full
    #    prefill's hidden states): its cell's prefill over S + 1 positions
    #    against its prefill over S and one decode step, held to
    #    SERVE_F32_TOL. (b) End to end, reported, not held: random weights
    #    make the stack amplify rounding (PERF.md, PR 24), so beside the
    #    float32 and bf16 readings stands the float32 prefill's own response
    #    to a 1e-7 relative perturbation of the embedding
    B1 = 2
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    net32 = copy.deepcopy(net).float()
    layer_errs = layer_decode_vs_prefill(net32, tokens[:B1], S)
    full32, step32 = decode_vs_prefill(cfg32, net32, tokens[:B1], S, dev)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(1)
        net32.embed.mul_(1.0 + 1e-7 * torch.randn(net32.embed.shape, generator=gen, device=dev))
    moved32, _ = llm.make_prefill_step(cfg32)(
        net32, llm.init_cache(cfg32, B1, S + 1, device=dev), {"tokens": tokens[:B1]})
    del net32
    scale32 = float(full32.abs().max())
    err32 = float((step32 - full32).abs().max()) / scale32
    noise32 = float((moved32.float() - full32).abs().max()) / scale32
    full16, step16 = decode_vs_prefill(cfg, net, tokens[:B1], S, dev)
    err16 = float((step16 - full16).abs().max()) / float(full16.abs().max())
    emit("llm_xlstm", check="decode vs prefill on the card", tokens=S + 1, batch=B1,
         float32_by_layer_max_rel_err=layer_errs, float32_by_layer_tol=SERVE_F32_TOL,
         float32_end_to_end=err32, float32_end_to_end_of_1e7_embedding_noise=noise32,
         bf16_prefill_vs_float32=float((full16 - full32).abs().max()) / scale32,
         bf16_decode_vs_bf16_prefill=err16, bf16_tol=SERVE_BF16_TOL,
         bf16_share_of_tol=err16 / SERVE_BF16_TOL, bf16_within_tol=err16 <= SERVE_BF16_TOL,
         argmax_agreement_float32=float((step32.argmax(-1) == full32.argmax(-1)).float().mean()),
         argmax_agreement_bf16=float((step16.argmax(-1) == full16.argmax(-1)).float().mean()))
    run.update(decode_vs_prefill_by_layer=max(layer_errs), decode_vs_prefill=err32,
               decode_vs_prefill_noise_floor=noise32, decode_vs_prefill_bf16=err16,
               decode_vs_prefill_bf16_share_of_tol=err16 / SERVE_BF16_TOL)
    res["serve"] = run
    del net
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# qwen2-moe-a2.7b's serving path: GQA attention at head dim 128 (the flash
# forward's width-128 instance, decode attention) and the MoE block
# ---------------------------------------------------------------------------
# the float32 card-against-CPU check: one MoE layer at full width, a short
# prompt and a few decode steps
MOE_CHECK_B, MOE_CHECK_S, MOE_CHECK_STEPS = 2, 128, 4


@contextlib.contextmanager
def moe_routes():
    """Inside, every ``MoE.route`` call's result is appended to the yielded
    list."""
    seen, orig = [], MoE.route

    def recorded(self, x):
        r = orig(self, x)
        seen.append(r)
        return r

    MoE.route = recorded
    try:
        yield seen
    finally:
        MoE.route = orig


@contextlib.contextmanager
def moe_capacity_factor(net, factor: float):
    """Inside, every MoE block of ``net`` routes with capacity factor
    ``factor`` (the same weights)."""
    blocks_ = [m for m in net.modules() if isinstance(m, MoE)]
    saved = [m.cfg for m in blocks_]
    for m in blocks_:
        m.cfg = dataclasses.replace(m.cfg, moe_capacity_factor=factor)
    try:
        yield
    finally:
        for m, c in zip(blocks_, saved):
            m.cfg = c


def moe_layer_decode_vs_prefill(net, tokens, s: int) -> dict:
    """For each layer of an MoE ``net``, in float32 (a copy of the layer at
    a time) on the same inputs (the hidden states of a float32 prefill over
    ``tokens [b, s + 1]``): the layer's contribution at position ``s`` by a
    decode step after a prefill over the first ``s`` positions, against its
    prefill over all ``s + 1``. The prefill's MoE groups the whole sequence,
    where the last token's pairs come last in every expert's queue, and a
    decode step groups the token alone (capacity 1, nothing dropped): a
    layer is held to SERVE_F32_TOL only where the prefill dropped none of
    the last token's pairs; the rest are reported. Beside it, end to end in
    float32 without holding the model in float32: the decode path's own
    hidden state at position ``s`` carried through every layer (each
    decode step on the cache of the full prefill's first ``s`` positions,
    which the last token does not change), its logits against the full
    prefill's (reported)."""
    cfg = net.cfg
    k = cfg.n_experts_active
    held, excluded = [], []
    with torch.no_grad():
        x = net.embed[tokens].float()
        x_dec = x[:, s]
        b = tokens.shape[0]
        full_t = net.rope_tables(torch.arange(s + 1, device=x.device))
        part_t = net.rope_tables(torch.arange(s, device=x.device))
        step_t = net.rope_tables(torch.full((1,), s, device=x.device))
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        for i, layer in enumerate(net.layers):
            l32 = copy.deepcopy(layer).float()
            with moe_routes() as routes:
                y_full, _ = llm_stack._block(l32, x, full_t)
            last_dropped = int((~routes[0].keep[:, -k:]).sum())
            cache = {"kv": init_attention_cache(cfg32, b, s + 1, device=x.device)}
            llm_stack._block(l32, x[:, :s], part_t, cache)
            y_step = llm_stack._block_decode(l32, x[:, s], cache, s, step_t)
            x_dec = llm_stack._block_decode(l32, x_dec, cache, s, step_t)
            got, want = y_step - x[:, s], y_full[:, s] - x[:, s]
            if last_dropped:
                excluded.append(dict(layer=i, last_token_pairs_dropped=last_dropped,
                                     max_rel_err=float((got.double() - want.double()).abs().max())
                                     / float(want.abs().max())))
            else:
                held.append(rel_err(f"moe layer {i} decode vs prefill", got, want, SERVE_F32_TOL))
            x = y_full
            del l32
        head = net.head.float()
        logits = [rms_norm(h, net.final_norm, cfg.norm_eps) @ head for h in (x[:, s], x_dec)]
    end_to_end = float((logits[1] - logits[0]).abs().max()) / float(logits[0].abs().max())
    return dict(held_max_rel_err=held, excluded=excluded, float32_end_to_end=end_to_end)


def phase_llm_moe(dev) -> dict:
    """qwen2-moe-a2.7b's serving path on the card: (1) one MoE layer at full
    width in float32, the card against the CPU path; (2) the model at full
    width in bf16 (random weights from a seed): prefill 8 x 2,048 tokens and
    64 greedy decode steps, launches counted from 0 a run, the pairs the
    prefill's MoE dropped per layer, device time by kernel; (3) decode
    against prefill, layer by layer in float32 (held where the prefill
    dropped none of the last token's pairs) and end to end in bf16
    (reported against SERVE_BF16_TOL), at the config's capacity and again
    at a capacity that drops nothing, where every layer is held."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(QWEN_MOE)
    B, S, N = LLM_B, LLM_S, LLM_NEW
    res = {}
    # 1. float32, one MoE layer at full width: the card against the CPU
    #    path, logits of the prompt and of each decode step, the KV cache
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    card_net, cpu_net = seeded_pair(cfg1, dev)
    B2, S2, steps = MOE_CHECK_B, MOE_CHECK_S, MOE_CHECK_STEPS
    toks = torch.randint(0, cfg.vocab_size, (B2, S2 + steps),
                         generator=torch.Generator().manual_seed(7))
    caches = [llm.init_cache(cfg1, B2, S2 + steps, device=dev),
              llm.init_cache(cfg1, B2, S2 + steps, device="cpu")]
    prefill1, step1 = llm.make_prefill_step(cfg1), llm.make_serve_step(cfg1)
    got, caches[0] = prefill1(card_net, caches[0], {"tokens": toks[:, :S2].to(dev)})
    want, caches[1] = prefill1(cpu_net, caches[1], {"tokens": toks[:, :S2]})
    errs = [rel_err("moe card vs CPU prefill", got.cpu(), want, SERVE_F32_TOL)]
    for i in range(steps):
        got, caches[0] = step1(card_net, caches[0], toks[:, S2 + i].to(dev))
        want, caches[1] = step1(cpu_net, caches[1], toks[:, S2 + i])
        errs.append(rel_err(f"moe card vs CPU step {i}", got.cpu(), want, SERVE_F32_TOL))
    kv_err = max(rel_err(f"moe card vs CPU cache {n}", caches[0]["layers"][0]["kv"][n].cpu(),
                         caches[1]["layers"][0]["kv"][n], SERVE_F32_TOL) for n in ("k", "v"))
    emit("llm_moe", check="card vs CPU path, float32", layers=cfg1.n_layers, batch=B2,
         prompt=S2, steps=steps, max_rel_err_by_step=errs, kv_max_rel_err=kv_err,
         tol=SERVE_F32_TOL)
    res["card_vs_cpu"] = max(errs + [kv_err])
    del cpu_net, card_net, caches

    # 2. qwen2-moe-a2.7b at full width, bf16
    t0 = time.perf_counter()
    net = llm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    prefill, step = llm.make_prefill_step(cfg), llm.make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    batch = {"tokens": tokens[:, :S]}
    logits, cache = prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)  # warm-up
    greedy_decode(step, net, cache, logits, 2)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = llm.init_cache(cfg, B, S + N, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(net, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_run = {"prefill": llm_counts()}
    first = logits.argmax(-1)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = greedy_decode(step, net, cache, logits, N)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    by_run["decode"] = llm_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"moe serve logits not finite [{B}, {cfg.vocab_size}]")
    if cache["pos"] != S + N:
        raise AssertionError(f"moe cache pos {cache['pos']} after {S} + {N} tokens")
    zero = {k_: 0 for k_ in llm_counts()}
    want = {"prefill": {**zero, "flash_attention_fwd": cfg.n_layers},
            "decode": {**zero, "decode_attention": cfg.n_layers * N}}
    if by_run != want:
        raise AssertionError(f"moe launches {by_run}, expected {want}")
    graph = [t for t in (logits, *(x for c in cache["layers"] for d in c.values()
                                   for x in d.values())) if t.requires_grad]
    if graph:
        raise AssertionError(f"moe serving recorded an autograd graph on {len(graph)} outputs")
    # the (token, choice) pairs the prefill's MoE dropped, per layer, in a
    # second prefill
    with moe_routes() as routes:
        prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)
    dropped = [int((~r.keep).sum()) for r in routes]
    run = dict(layers=cfg.n_layers, params=n_params, param_count=cfg.param_count(), batch=B,
               prompt=S, new_tokens=N, init_s=init_s, prefill_s=prefill_s,
               prefill_tokens_per_s=B * S / prefill_s, decode_s=decode_s,
               decode_ms_per_step=decode_s / N * 1e3, decode_tokens_per_s=B * N / decode_s,
               peak_memory_gb=peak / 1e9, launches_by_run=by_run, first_tokens=first.tolist(),
               capacity=routes[0].capacity, pairs=B * S * cfg.n_experts_active,
               dropped_pairs_by_layer=dropped)
    emit("llm_moe", card=smi(), **run)
    # device time by kernel of one prefill and one decode step, beside the
    # unprofiled walls
    prof = {}
    for label, fn, wall in (
        ("prefill", lambda: prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch),
         prefill_s),
        ("decode_step", lambda: step(net, cache, logits.argmax(-1)), decode_s / N),
    ):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:  # device events alone
            fn()
            torch.cuda.synchronize()
        rows = device_rows(pr)
        dev_s = sum(r[1] for r in rows) / 1e6
        kern = lambda tag: sum(r[1] for r in rows if tag in r[0]) / 1e6
        prof[label] = dict(device_s=dev_s, wall_s=wall, busy_share=dev_s / wall,
                           flash_s=kern("flash_fwd"), decode_attention_s=kern("decode_kernel"),
                           device_launches=sum(r[2] for r in rows),
                           top=[[k_[:70], us / 1e6, n] for k_, us, n in rows[:10]])
        emit("llm_moe", profile=label, **prof[label])
    run["profile"] = prof
    del cache

    # 3. decode against prefill, 2 prompts: layer by layer in float32 on
    #    the same inputs, then end to end in bf16; first at the config's
    #    capacity, then again with room for every pair (capacity factor
    #    E / k: an expert's queue holds the whole sequence), where no layer
    #    is excluded
    B1 = 2
    no_drop = cfg.n_experts / cfg.n_experts_active
    checks = {}
    for label, factor in (("capacity", cfg.moe_capacity_factor), ("no_drop", no_drop)):
        with moe_capacity_factor(net, factor):
            layers = moe_layer_decode_vs_prefill(net, tokens[:B1], S)
            full16, step16 = decode_vs_prefill(cfg, net, tokens[:B1], S, dev)
        if label == "no_drop" and layers["excluded"]:
            raise AssertionError(f"moe decode vs prefill at capacity factor {factor}: "
                                 f"{len(layers['excluded'])} layers dropped pairs")
        err16 = float((step16 - full16).abs().max()) / float(full16.abs().max())
        checks[label] = dict(
            capacity_factor=factor, float32_by_layer_max_rel_err=layers["held_max_rel_err"],
            float32_by_layer_tol=SERVE_F32_TOL, layers_held=len(layers["held_max_rel_err"]),
            layers_excluded=len(layers["excluded"]), excluded=layers["excluded"],
            float32_end_to_end=layers["float32_end_to_end"], bf16_decode_vs_bf16_prefill=err16, bf16_tol=SERVE_BF16_TOL,
            bf16_share_of_tol=err16 / SERVE_BF16_TOL, bf16_within_tol=err16 <= SERVE_BF16_TOL,
            argmax_agreement_bf16=float((step16.argmax(-1) == full16.argmax(-1)).float().mean()))
        emit("llm_moe", check="decode vs prefill on the card", routing=label, tokens=S + 1,
             batch=B1, **checks[label])
    run.update(decode_vs_prefill_by_layer={k_: max(v_["float32_by_layer_max_rel_err"], default=None)
                                           for k_, v_ in checks.items()},
               decode_vs_prefill_layers_excluded=checks["capacity"]["layers_excluded"],
               decode_vs_prefill_bf16={k_: v_["bf16_decode_vs_bf16_prefill"]
                                       for k_, v_ in checks.items()})
    res["serve"] = run
    del net
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# the encoder-decoder stack (seamless-m4t-large-v2) and the vision frontend
# (internvl2-2b): their serving paths on the flash forward without a mask
# and across sequences, and decode attention
# ---------------------------------------------------------------------------
# the card against the CPU path in float32: layers kept of the decoder (and
# of the encoder), prompts, prompt tokens (past internvl2's 256-position
# prefix), decode steps
ENCDEC_CHECK_LAYERS, ENCDEC_CHECK_B, ENCDEC_CHECK_S, ENCDEC_CHECK_STEPS = 2, 2, 320, 4


def frontend_embeds(cfg, b: int, dev, seed: int) -> torch.Tensor:
    """``[b, frontend_tokens, frontend_dim]`` float32 stand-ins of a
    frontend's precomputed embeddings (speech frames, image patches), from a
    seed."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim), generator=g).to(dev)


def stack_layer_decode_vs_prefill(net, batch, s: int) -> list:
    """For each decoder layer of an attention ``net`` (an encoder-decoder's
    with its cross-attention), in float32 (a copy of the layer at a time)
    on the same inputs (the hidden states of a prefill over ``batch``'s ``s
    + 1`` positions and the float32 encoder output): the layer's
    contribution at position ``s`` by a decode step after a prefill over
    the first ``s`` positions, against its prefill over all ``s + 1``;
    raises past SERVE_F32_TOL."""
    cfg = net.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    errs = []
    with torch.no_grad():
        enc = None
        if cfg.is_encdec:
            e = batch["frontend_embeds"].float() @ net.frontend_proj.float()
            tables = net.rope_tables(torch.arange(e.shape[1], device=e.device))
            for layer in net.encoder:
                e, _ = llm_stack._block(copy.deepcopy(layer).float(), e, tables)
            enc = rms_norm(e, net.enc_final_norm, cfg.norm_eps)
        x = llm_stack.embed_inputs(net, batch, cfg).float()
        b = x.shape[0]
        full_t = net.rope_tables(torch.arange(s + 1, device=x.device))
        part_t = net.rope_tables(torch.arange(s, device=x.device))
        step_t = net.rope_tables(torch.full((1,), s, device=x.device))
        for i, layer in enumerate(net.layers):
            l32 = copy.deepcopy(layer).float()
            y_full, _ = llm_stack._block(l32, x, full_t, None, enc)
            cache = llm_stack._init_block_cache(cfg32, layer.kind, b, s + 1, x.device)
            llm_stack._block(l32, x[:, :s], part_t, cache, enc)
            y_step = llm_stack._block_decode(l32, x[:, s], cache, s, step_t)
            errs.append(rel_err(f"{cfg.name} layer {i} decode vs prefill", y_step - x[:, s],
                                y_full[:, s] - x[:, s], SERVE_F32_TOL))
            x = y_full
            del l32, cache
    return errs


def encdec_card_vs_cpu(arch: str, dev) -> float:
    """The card against the CPU path in float32 at full width and reduced
    depth (ENCDEC_CHECK_LAYERS of the decoder and of the encoder): the
    prompt's logits, every cache tensor (the self-attention's keys and
    values, the cross-attention's), and each decode step's logits."""
    cfg = configs.get_config(arch)
    n = ENCDEC_CHECK_LAYERS
    cfg2 = dataclasses.replace(cfg, n_layers=n, encoder_layers=min(cfg.encoder_layers, n),
                               dtype="float32")
    card_net, cpu_net = seeded_pair(cfg2, dev)
    B2, S2, steps = ENCDEC_CHECK_B, ENCDEC_CHECK_S, ENCDEC_CHECK_STEPS
    toks = torch.randint(0, cfg.vocab_size, (B2, S2 + steps),
                         generator=torch.Generator().manual_seed(7))
    fe = frontend_embeds(cfg, B2, "cpu", seed=8)
    prefill2, step2 = llm.make_prefill_step(cfg2), llm.make_serve_step(cfg2)
    runs = []
    for net, where in ((card_net, dev), (cpu_net, "cpu")):
        cache = llm.init_cache(cfg2, B2, S2 + steps, device=where)
        logits, cache = prefill2(net, cache, {"tokens": toks[:, :S2].to(where),
                                              "frontend_embeds": fe.to(where)})
        runs.append([logits.cpu()])
        for i in range(steps):
            logits, cache = step2(net, cache, toks[:, S2 + i].to(where))
            runs[-1].append(logits.cpu())
        runs[-1].append(cache)
    (*got, card_cache), (*want, cpu_cache) = runs
    errs = [rel_err(f"{arch} card vs CPU {'prefill' if i == 0 else f'step {i - 1}'}", a, b,
                    SERVE_F32_TOL) for i, (a, b) in enumerate(zip(got, want))]
    cache_err = max(rel_err(f"{arch} card vs CPU cache layer {l} {key} {t}", a[key][t].cpu(),
                            b[key][t], SERVE_F32_TOL)
                    for l, (a, b) in enumerate(zip(card_cache["layers"], cpu_cache["layers"]))
                    for key in a for t in a[key])
    emit("llm_encdec", arch=arch, check="card vs CPU path, float32", layers=cfg2.n_layers,
         encoder_layers=cfg2.encoder_layers, batch=B2, prompt=S2, steps=steps,
         frontend=[cfg.frontend_tokens, cfg.frontend_dim], max_rel_err_by_step=errs,
         cache_max_rel_err=cache_err, cache_keys=sorted(card_cache["layers"][0]),
         tol=SERVE_F32_TOL)
    return max(errs + [cache_err])


def encdec_serve(arch: str, dev) -> dict:
    """``arch`` at full width and depth in bf16 (random weights from a
    seed): prefill 8 x 2,048 prompt tokens with 8 frontend inputs from a
    seed, 64 greedy decode steps, launches counted from 0 a run and held to
    their counts, peak memory, device time by kernel of a prefill and a
    decode step; then decode against prefill, layer by layer in float32
    (held) and end to end in bf16 (reported against SERVE_BF16_TOL)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(arch)
    B, S, N = LLM_B, LLM_S, LLM_NEW
    t0 = time.perf_counter()
    net = llm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    prefill, step = llm.make_prefill_step(cfg), llm.make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    fe = frontend_embeds(cfg, B, dev, seed=1)
    batch = {"tokens": tokens[:, :S], "frontend_embeds": fe}
    logits, cache = prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch)  # warm-up
    greedy_decode(step, net, cache, logits, 2)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = llm.init_cache(cfg, B, S + N, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(net, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_run = {"prefill": llm_counts()}
    first = logits.argmax(-1)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = greedy_decode(step, net, cache, logits, N)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    by_run["decode"] = llm_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch} serve logits not finite [{B}, {cfg.vocab_size}]")
    if cache["pos"] != S + N:
        raise AssertionError(f"{arch} cache pos {cache['pos']} after {S} + {N} tokens")
    # a prefill: the encoder's layers, the decoder's self-attention and its
    # cross-attention; a decode step: decode attention and, in an
    # encoder-decoder, the cross-attention's one row on the flash forward
    L, cross = cfg.n_layers, cfg.n_layers if cfg.is_encdec else 0
    zero = {k_: 0 for k_ in llm_counts()}
    want = {"prefill": {**zero, "flash_attention_fwd": cfg.encoder_layers + L + cross},
            "decode": {**zero, "flash_attention_fwd": cross * N, "decode_attention": L * N}}
    if by_run != want:
        raise AssertionError(f"{arch} launches {by_run}, expected {want}")
    graph = [t for t in (logits, *(x for c in cache["layers"] for d in c.values()
                                   for x in d.values())) if t.requires_grad]
    if graph:
        raise AssertionError(f"{arch} serving recorded an autograd graph on {len(graph)} outputs")
    run = dict(arch=arch, layers=L, encoder_layers=cfg.encoder_layers, params=n_params,
               param_count=cfg.param_count(), batch=B, prompt=S, new_tokens=N,
               frontend=[cfg.frontend, cfg.frontend_tokens, cfg.frontend_dim], init_s=init_s,
               prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s, decode_s=decode_s,
               decode_ms_per_step=decode_s / N * 1e3, decode_tokens_per_s=B * N / decode_s,
               peak_memory_gb=peak / 1e9, launches_by_run=by_run, first_tokens=first.tolist())
    emit("llm_encdec", card=smi(), **run)
    prof = {}
    for label, fn, wall in (
        ("prefill", lambda: prefill(net, llm.init_cache(cfg, B, S + N, device=dev), batch),
         prefill_s),
        ("decode_step", lambda: step(net, cache, logits.argmax(-1)), decode_s / N),
    ):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:  # device events alone
            fn()
            torch.cuda.synchronize()
        rows = device_rows(pr)
        dev_s = sum(r[1] for r in rows) / 1e6
        kern = lambda tag: sum(r[1] for r in rows if tag in r[0]) / 1e6
        prof[label] = dict(device_s=dev_s, wall_s=wall, busy_share=dev_s / wall,
                           flash_s=kern("flash_fwd"), decode_attention_s=kern("decode_kernel"),
                           device_launches=sum(r[2] for r in rows),
                           top=[[k_[:70], us / 1e6, n] for k_, us, n in rows[:10]])
        emit("llm_encdec", arch=arch, profile=label, **prof[label])
    run["profile"] = prof
    del cache

    # decode against prefill on 2 prompts: layer by layer in float32 on the
    # same inputs (held), end to end in bf16 (reported)
    B1 = 2
    one = {"tokens": tokens[:B1], "frontend_embeds": fe[:B1]}
    layers = stack_layer_decode_vs_prefill(net, one, S)
    full16, step16 = decode_vs_prefill(cfg, net, tokens[:B1], S, dev, frontend=fe[:B1])
    err16 = float((step16 - full16).abs().max()) / float(full16.abs().max())
    check = dict(float32_by_layer_max_rel_err=layers, float32_by_layer_tol=SERVE_F32_TOL,
                 bf16_decode_vs_bf16_prefill=err16, bf16_tol=SERVE_BF16_TOL,
                 bf16_share_of_tol=err16 / SERVE_BF16_TOL, bf16_within_tol=err16 <= SERVE_BF16_TOL,
                 argmax_agreement_bf16=float((step16.argmax(-1) == full16.argmax(-1)).float().mean()))
    emit("llm_encdec", arch=arch, check="decode vs prefill on the card", tokens=S + 1, batch=B1,
         **check)
    run.update(decode_vs_prefill_by_layer=max(layers), decode_vs_prefill_bf16=err16)
    del net
    torch.cuda.synchronize()
    return run


def phase_llm_encdec(dev) -> dict:
    """seamless-m4t-large-v2 (the encoder-decoder: 24 encoder layers over
    1,024 speech frames, 24 decoder layers with cross-attention) and
    internvl2-2b (256 image embeddings in front of the prompt, D 128, 16 / 8
    heads) on the card: each at reduced depth in float32 against the CPU
    path, then at full width and depth in bf16 (:func:`encdec_serve`)."""
    res = {}
    for arch in (SEAMLESS, INTERNVL):
        res[arch] = dict(card_vs_cpu=encdec_card_vs_cpu(arch, dev), serve=encdec_serve(arch, dev))
    return res


# ---------------------------------------------------------------------------
# the LLM substrate's training path (tinyllama-1.1b)
# ---------------------------------------------------------------------------
TINYLLAMA = "tinyllama-1.1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 5
# flash backward, kernel vs plain in float32, relative to each gradient's
# max|plain|: the same sums in another order, where dp - delta cancels
BWD_TOL_F32 = 1e-4
# and row by row (all but the last dim): each row within BWD_ROW_TOL_F32 of
# its own max|plain| plus BWD_FLOOR_F32 of the gradient's max|plain|, the
# floor for rows whose sums cancel to about 0. The plain version's own
# float32 roundoff (against float64, B 1 x 1,024 tokens, 8/1 heads, bf16
# values) is up to 1.6e-6 of a row's max and 5.6e-7 of the gradient's.
BWD_ROW_TOL_F32, BWD_FLOOR_F32 = 1e-4, 1e-5
# one float32 train step, the card against the CPU path (cuBLAS and the
# kernels against MKL and the plain versions, 2 layers of TinyLlama's
# widths): the loss within 1e-5 of itself, the grad norm within 1e-4, each
# gradient within 1e-4 of its own max|CPU|
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
# bf16's unit roundoff: round-to-nearest moves x by at most 2^-8 |x|
BF16_U = 2.0 ** -8
# seeds (q/k/v, dout) of the backward check at TinyLlama's shapes
TRAIN_BWD_SEEDS = ((21, 22), (31, 32), (41, 42))
# hymba-1.5b's train step: 1 warm-up and 3 timed steps
HYMBA_TRAIN_STEPS = 3
# the SSD backward (ops.MlstmChunk: ref.mlstm_chunk_bwd in torch ops), card
# against CPU path on the same inputs: (normalize, S, Dk, Dv) at chunk 128,
# S 100 and 300 (a padded last chunk), float32 and bf16 q, k, v
SSD_BWD_CASES = tuple((n, S_, dk, dv) for n in (True, False) for S_ in (100, 300)
                      for dk, dv in ((16, 32), (64, 128)))
# record_function ranges: the profiler may show each as a device-side row
# spanning its kernels, which the sums of kernel time must not count again
ANNOTATIONS = ("mlstm_chunk_bwd", "adamw_update")
# qwen2-moe-a2.7b's train step: 2 of its 24 layers (the full width does not
# fit one card with AdamW's moments), 8 x 2,048 tokens as 2 microbatches of
# 4 x 2,048 (the float32 logits of 8 x 2,048 tokens at vocab 151,936 are
# 9.96 GB, and with their gradient and the AdamW copies one pass would peak
# near 70 GB), 1 warm-up and 3 timed steps
MOE_TRAIN_LAYERS, MOE_TRAIN_ACCUM, MOE_TRAIN_STEPS = 2, 2, 3


def bwd_row_limit(want32) -> torch.Tensor:
    """Each row's float32 limit: BWD_ROW_TOL_F32 of the row's max|plain|
    plus BWD_FLOOR_F32 of the tensor's; set from the plain values alone."""
    w = want32.double().abs()
    return BWD_ROW_TOL_F32 * w.amax(-1) + BWD_FLOOR_F32 * w.max()


def row_share(got, want, limit) -> float:
    """The largest over rows of ``max|got - want|`` as a share of ``limit``
    (a tensor of the rows' shape); <= 1 when every row holds."""
    diff = (got.double() - want.double()).abs().amax(-1)
    zero = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(limit > 0, diff / limit.clamp_min(1e-300), zero).max())


def bf16_step(top) -> torch.Tensor:
    """One bf16 step (2^-7 of the binade) at each row's ``top``; 0 where
    ``top`` is 0."""
    return torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-300))) - 7), 0.0)


def bf16_bwd_row_limit(want32, magnitude=None) -> torch.Tensor:
    """Each bf16 row's limit, from the plain values alone (a rounding
    model): the float32 row limit (the sums' order), plus BF16_U of the
    row's largest magnitude sum where the kernel rounds operands to bf16
    before a product (dv: |P|^T |dout|, dk: scale |dS|^T |Q|, summed over
    the GQA group; dq: scale |dS| |K|; from
    ``ref.flash_attention_bwd_magnitudes``), plus one bf16 step at the
    binade of the row's max|plain| widened by both: each side rounds its
    float32 result to nearest, half a step of the binade the value lands
    in."""
    lim = bwd_row_limit(want32)
    if magnitude is not None:
        lim = lim + BF16_U * magnitude.double().amax(-1)
    return lim + bf16_step(want32.double().abs().amax(-1) + lim)


def check_flash_bwd(label, q, k, v, dout, dtype, **kw) -> dict:
    """dq, dk, dv of the two kernels against ``ref.flash_attention_bwd`` on
    the forward kernel's out and lse, in float32 on the whole tensor and row
    by row. bf16 inputs are also run in float32 on the same values (the
    float32 kernels): those results meet the float32 limits, and each bf16
    row meets :func:`bf16_bwd_row_limit`. No limit is read from the
    kernel's own output. Returns the largest float32 error and each
    gradient's bf16 row share of its limit and of the old "one step of the
    row's max|plain| plus its float32 limit"."""
    out, lse = flash_attention.flash_attention_cuda(q, k, v, **kw)
    got = flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    mags = (None, None, None)
    if dtype == torch.float32:
        got32, want32 = got, want
    else:
        up = [x.float() for x in (q, k, v, out)]
        got32 = flash_attention.flash_attention_bwd_cuda(*up, lse, dout.float(), **kw)
        want32 = ref.flash_attention_bwd(*up, lse, dout.float(), **kw)
        mags = ref.flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw)
    errs, f32_share, bf16_share, old_share = [], [], [], []
    for name, a, b, a32, b32, mag in zip("qkv", got, want, got32, want32, mags):
        errs.append(rel_err(f"flash bwd {label} d{name} (float32)", a32, b32, BWD_TOL_F32))
        limit = bwd_row_limit(b32)
        f32_share.append(row_share(a32, b32, limit))
        if not f32_share[-1] <= 1.0:
            raise AssertionError(f"flash bwd {label} d{name}: a float32 row's error is "
                                 f"{f32_share[-1]} of its row limit")
        if dtype == torch.bfloat16:
            bf16_share.append(row_share(a, b, bf16_bwd_row_limit(b32, mag)))
            old_share.append(row_share(a, b, bf16_step(b.double().abs().amax(-1)) + limit))
            if not bf16_share[-1] <= 1.0:
                raise AssertionError(f"flash bwd {label} d{name}: a bf16 row's error is "
                                     f"{bf16_share[-1]} of its rounding-model limit")
    emit("llm_train_kernels", kernels="flash_attention_bwd_dq+dkv", case=label, dtype=str(dtype),
         shape=[list(q.shape), list(k.shape)], max_rel_err_dq_dk_dv=errs, tol=BWD_TOL_F32,
         f32_row_share_of_limit_dq_dk_dv=f32_share, row_tol=BWD_ROW_TOL_F32, floor=BWD_FLOOR_F32,
         bf16_row_share_of_limit_dq_dk_dv=bf16_share or None,
         bf16_row_share_of_old_limit_dq_dk_dv=old_share or None,
         dead_rows=int(torch.isinf(lse).sum()),
         live_rows=int(torch.isfinite(lse).sum()), **{k_: v_ for k_, v_ in kw.items()})
    return dict(err=max(errs), bf16_share=bf16_share, old_share=old_share)


def mlstm_grads(args, dout, chunk, normalize):
    """``torch.autograd.grad`` through ``ops.mlstm_chunk`` (the
    ``MlstmChunk`` Function) in all five inputs, against ``dout``."""
    leaves = [x.detach().clone().requires_grad_() for x in args]
    out = ops.mlstm_chunk(*leaves, chunk=chunk, normalize=normalize)
    return torch.autograd.grad(out, leaves, dout)


def check_mlstm_bwd(label, args, chunk, normalize) -> float:
    """The SSD / mLSTM backward on the card against the CPU path on the same
    inputs (bf16 ``q, k, v`` as the same bf16 values on the CPU) and a fixed
    ``dout``: the float32 gradients ``ref.mlstm_chunk_bwd`` computes, each
    within TRAIN_GRAD_TOL of its own max|CPU| (the same float32 function,
    cuBLAS against MKL); the Function's gradients on each device are those,
    cast to the inputs' dtypes, bit for bit."""
    g = torch.Generator().manual_seed(args[0].shape[1] + args[2].shape[-1])
    dout = torch.randn(args[2].shape, generator=g).to(args[2].dtype)
    cpu_args = [x.cpu() for x in args]
    errs = []
    got = {}
    for where, xs, d in (("card", args, dout.to(args[0].device)), ("cpu", cpu_args, dout)):
        grads = mlstm_grads(xs, d, chunk, normalize)
        f32 = ref.mlstm_chunk_bwd(*xs, d, chunk=chunk, normalize=normalize)
        for name, x, a, b in zip(("q", "k", "v", "i_gate", "f_gate"), xs, grads, f32):
            if a.dtype != x.dtype or not torch.equal(a, b.to(x.dtype)):
                raise AssertionError(f"mlstm bwd {label} d{name} ({where}): the Function's "
                                     "gradient is not the backward's, cast to the input's dtype")
        got[where] = f32
    for name, a, b in zip(("q", "k", "v", "i_gate", "f_gate"), got["card"], got["cpu"]):
        errs.append(rel_err(f"mlstm bwd {label} d{name} (card vs CPU)", a.cpu(), b,
                            TRAIN_GRAD_TOL))
    emit("llm_train_kernels", check="mlstm_chunk backward, card vs CPU path", case=label,
         dtype=str(args[0].dtype), normalize=normalize, chunk=chunk, q=list(args[0].shape),
         v=list(args[2].shape), max_rel_err_dq_dk_dv_di_df=errs, tol=TRAIN_GRAD_TOL)
    return max(errs)


def ssd_bwd_timing(hy, dev, max_abs_err: float) -> dict:
    """The SSD backward (``ref.mlstm_chunk_bwd``, torch ops) at ``hy``'s
    SSD training shapes (B 8, S 2,048, bf16 q, k, v, normalize False) with
    CUDA events and profiler device time, its launches a call and its
    bound, beside the forward kernel and the loop recompute."""
    B, S, bf = TRAIN_B, TRAIN_S, torch.bfloat16
    H, Dk, Dv, chunk = hy.n_heads, hy.ssm_state, hy.ssm_expand * hy.d_model // hy.n_heads, 128
    args = mlstm_case(B, S, H, Dk, Dv, False, bf, seed=13, dev=dev)
    dout = torch.randn(args[2].shape, generator=torch.Generator().manual_seed(14)).to(dev).to(bf)
    fwd_ms, _ = timed(lambda: mlstm_chunk.mlstm_chunk_cuda(*args, chunk=chunk, normalize=False), 20)
    bwd = lambda: ref.mlstm_chunk_bwd(*args, dout, chunk=chunk, normalize=False)
    bwd_ms, grads = timed(bwd, 5)
    launches = []
    bwd_dev_ms = device_ms(bwd, 2, counted=launches)
    # beside it, autograd through the loop over chunks that the kernel runs
    # (ref.mlstm_chunk_chunked), the backward's simplest form: the same
    # gradients, its sums in another order
    def loop():
        with torch.enable_grad():
            xs = [x.detach().float().requires_grad_() for x in args]
            out = ref.mlstm_chunk_chunked(*xs, chunk=chunk, normalize=False)
            return torch.autograd.grad(out, xs, dout.float())
    loop_ms, loop_grads = timed(loop, 5)
    loop_launches = []
    loop_dev_ms = device_ms(loop, 2, counted=loop_launches)
    loop_err = max(rel_err(f"mlstm bwd closed form vs loop d{n}", a, b, TRAIN_GRAD_TOL)
                   for n, a, b in zip(("q", "k", "v", "i_gate", "f_gate"), grads, loop_grads))
    del loop_grads
    fwd_bwd_ms, _ = timed(lambda: mlstm_grads(args, dout, chunk, False), 5)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bwd()
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    n_chunks = -(-S // chunk)
    # the chunked form's float32 operations over the causal half: the
    # forward (scores and their products with v, the inter-chunk q C, the
    # state update k^T v), and the backward's two products for each of its
    # products, all recomputed with it
    fwd_ops = B * H * n_chunks * 2 * (chunk * chunk // 2 * (Dk + Dv) + 2 * chunk * Dk * Dv)
    bwd_ops = 3 * fwd_ops
    bytes_ = nbytes(*args, dout) + nbytes(*args)  # gradients in the inputs' dtypes
    t_b, t_o = bytes_ / PEAK_BYTES, bwd_ops / PEAK_FP32
    res = dict(
        ms=bwd_ms, device_ms=bwd_dev_ms, plain_ms=bwd_ms, bound_ms=max(t_b, t_o) * 1e3,
        bound_by="bytes" if t_b >= t_o else "operations", library_ms=None,
        launches_per_call=launches[0], ops=bwd_ops, bytes=bytes_, fwd_kernel_ms=fwd_ms,
        fwd_bwd_ms=fwd_bwd_ms, peak_extra_gb=bwd_peak / 1e9, max_abs_err=max_abs_err,
        loop_ms=loop_ms, loop_device_ms=loop_dev_ms, loop_launches_per_call=loop_launches[0],
        loop_max_rel_err=loop_err)
    emit("llm_train_kernels", kernel="mlstm_chunk_bwd (torch ops, no TPU kernel)",
         timing="hymba SSD training shapes", card=smi(), shape=[B, S, H, Dk, Dv], chunk=chunk,
         plain="itself: ref.mlstm_chunk_bwd", library="none", **res)
    del args, dout, grads
    return res


def bwd_timing(q, k, v, dout, window=None) -> dict:
    """The bf16 dq and dk/dv kernels at a causal shape (and ``window``),
    timed by CUDA events beside their bounds (the kept pairs' products at
    the bf16 tensor-core rate, or their bytes), the plain backward and
    SDPA's backward (a band mask for a window). Keys ``dq`` and ``dkv``."""
    B, S, Hq, D = q.shape
    kw = dict(window=window)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, **kw)
    dq_ms, (_, delta) = timed(
        lambda: flash_attention.flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, **kw), 5)
    dkv_ms, _ = timed(
        lambda: flash_attention.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout, **kw), 5)
    plain_ms, _ = timed(lambda: ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw), 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    if window is None:
        graph = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        i = torch.arange(S, device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        graph = sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib_ms, _ = timed(lambda: torch.autograd.grad(graph, (qt, kt, vt), dout.transpose(1, 2),
                                                  retain_graph=True), 5)
    product = 2 * D * B * Hq * attention_pairs(S, S, True, window)  # one [pairs x D] product
    rows = 4 * B * Hq * S  # one float32 [B, Hq, S] row vector
    res = {}
    for name, ms, n_products, bytes_ in (
        # dq: s, dp, dq; reads q, k, v, out, dout, lse; writes dq, delta
        ("dq", dq_ms, 3, nbytes(q, k, v, out, dout, q) + 2 * rows),
        # dk/dv: s, dp, dk, dv; reads q, k, v, dout, lse, delta; writes dk, dv
        ("dkv", dkv_ms, 4, nbytes(q, k, v, dout, k, v) + 2 * rows),
    ):
        b_ms, b_by = bound(bytes_, n_products * product)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, ops=n_products * product, bytes=bytes_)
    del graph, qt, kt, vt
    return res


def llm_train_kernels_d128(dev) -> dict:
    """The flash dq and dk/dv kernels at head dims past 64 (their width-128
    instances) against the plain backward: the forward's D 128 / 96 / 77
    ragged cases and pointers off 16 bytes, float32 and bf16; then
    qwen2-moe-a2.7b's training shape (three seeds) and the dense D = 128
    configs' attention shapes (qwen2.5-14b 40 / 8, minitron-8b 32 / 8,
    gemma3-27b's local layers 32 / 16 at the 1,024 window), bf16, each
    timed (:func:`bwd_timing`). Keys ``flash_attention_bwd_dq_d128`` and
    ``flash_attention_bwd_dkv_d128``."""
    bf = torch.bfloat16
    err = 0.0
    for dtype in (torch.float32, bf):
        for label, shape, kw in FLASH_D128_CASES + (
                ("D128 unaligned", (2, 130, 200, 4, 2, 128), dict(causal=False)),
                ("D100 unaligned", (1, 70, 70, 4, 2, 100), dict())):
            q, k, v = flash_case(*shape, dtype, seed=shape[1] + shape[5] + 1, dev=dev)
            dout = flash_case(shape[0], shape[1], 1, shape[3], 1, shape[5], dtype,
                              seed=shape[1] + 2, dev=dev)[0]
            if "unaligned" in label:
                q, k, v, dout = (unaligned(x) for x in (q, k, v, dout))
            err = max(err, check_flash_bwd(label, q, k, v, dout, dtype, **kw)["err"])
    moe = configs.get_config(QWEN_MOE)
    B, S, D = TRAIN_B, TRAIN_S, moe.hd
    shares, rows = [], {}
    for seed, seed_dout in TRAIN_BWD_SEEDS:
        q, k, v = flash_case(B, S, S, moe.n_heads, moe.n_kv_heads, D, bf, seed=seed, dev=dev)
        dout = flash_case(B, S, 1, moe.n_heads, 1, D, bf, seed=seed_dout, dev=dev)[0]
        r = check_flash_bwd(f"{QWEN_MOE} train seed {seed}", q, k, v, dout, bf)
        err = max(err, r["err"])
        shares.append(dict(seed=seed, bf16_share_dq_dk_dv=r["bf16_share"]))
    emit("llm_train_kernels", check=f"bf16 backward row shares at {QWEN_MOE}'s training shape",
         seeds=shares)
    rows[QWEN_MOE] = bwd_timing(q, k, v, dout)
    del q, k, v, dout
    for arch in DENSE_D128:
        c = configs.get_config(arch)
        q, k, v = flash_case(B, S, S, c.n_heads, c.n_kv_heads, D, bf, seed=c.n_heads + 1, dev=dev)
        dout = flash_case(B, S, 1, c.n_heads, 1, D, bf, seed=c.n_heads + 2, dev=dev)[0]
        err = max(err, check_flash_bwd(f"{arch} train", q, k, v, dout, bf, window=c.window)["err"])
        rows[arch] = bwd_timing(q, k, v, dout, c.window)
        del q, k, v, dout
    torch.cuda.synchronize()
    res = {}
    for part in ("dq", "dkv"):
        for arch, r in rows.items():
            c = configs.get_config(arch)
            emit("llm_train_kernels", kernel=f"flash_attention_bwd_{part}_d128", timing=arch,
                 card=smi(), shape=[B, S, c.n_heads, c.n_kv_heads, D], causal=True,
                 window=None if arch == QWEN_MOE else c.window, width=128,
                 plain="ref.flash_attention_bwd (dq, dk and dv)",
                 library="backward of F.scaled_dot_product_attention(enable_gqa=True) "
                         "(dq, dk and dv; a band mask for a window)", **r[part])
        res[f"flash_attention_bwd_{part}_d128"] = dict(
            rows[QWEN_MOE][part], max_abs_err=err,
            dense_configs={a: {k_: rows[a][part][k_] for k_ in ("ms", "bound_ms", "library_ms")}
                           for a in DENSE_D128})
    return res


def phase_llm_train_kernels(dev) -> dict:
    """The dq and dk/dv kernels against the plain backward on ragged cases
    and at TinyLlama's training shapes (three seeds), the forward there
    too; then each timed with CUDA events beside its bound, the plain
    version and SDPA's forward and backward; Hymba's shapes; the width-128
    instances (:func:`llm_train_kernels_d128`); the SSD backward."""
    cfg = configs.get_config(TINYLLAMA)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, kw in (
            ("gqa8", (2, 150, 150, 16, 2, 64), dict()),
            ("gqa2_window", (2, 130, 130, 4, 2, 32), dict(window=17)),
            ("q_offset", (1, 40, 90, 6, 3, 20), dict(window=24, q_offset=50)),
            ("non_causal", (2, 77, 50, 2, 1, 48), dict(causal=False)),
            ("dead_rows", (1, 30, 20, 2, 2, 16), dict(window=4, q_offset=40)),
            ("mixed_dead_rows", (1, 30, 20, 2, 2, 16), dict(window=8, q_offset=10)),
            ("odd_d", (2, 70, 70, 4, 2, 17), dict()),
            ("unaligned", (2, 130, 200, 4, 2, 64), dict(causal=False)),
        ):
            q, k, v = flash_case(*shape, dtype, seed=shape[1] + 1, dev=dev)
            dout = flash_case(shape[0], shape[1], 1, shape[3], 1, shape[5], dtype,
                              seed=shape[1] + 2, dev=dev)[0]
            if label == "unaligned":
                q, k, v, dout = (unaligned(x) for x in (q, k, v, dout))
            err = max(err, check_flash_bwd(label, q, k, v, dout, dtype, **kw)["err"])

    # TinyLlama's shapes, bf16 (float32 on the same values inside the
    # check), three seeds: each gradient's bf16 row shares of the rounding
    # model's limit and of the old limit
    bf = torch.bfloat16
    B, S, Hq, Hkv, D = TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shares = []
    for seed, seed_dout in TRAIN_BWD_SEEDS:
        q, k, v = flash_case(B, S, S, Hq, Hkv, D, bf, seed=seed, dev=dev)
        dout = flash_case(B, S, 1, Hq, 1, D, bf, seed=seed_dout, dev=dev)[0]
        r = check_flash_bwd(f"main seed {seed}", q, k, v, dout, bf)
        err = max(err, r["err"])
        shares.append(dict(seed=seed, bf16_share_dq_dk_dv=r["bf16_share"],
                           old_share_dq_dk_dv=r["old_share"]))
    emit("llm_train_kernels", check="bf16 backward row shares at the main shapes", seeds=shares,
         dq_share_of_limit=[x["bf16_share_dq_dk_dv"][0] for x in shares],
         dq_share_of_old_limit=[x["old_share_dq_dk_dv"][0] for x in shares])
    # the forward kernel at these shapes too (8 query heads a KV head), with
    # the bf16 and float32 limits phase_llm_kernels applies
    fwd_err = max(check_flash("train main", q, k, v, bf, phase="llm_train_kernels"),
                  check_flash("train main", *(x.float() for x in (q, k, v)), torch.float32,
                              phase="llm_train_kernels"))
    fwd_ms, _ = timed(lambda: flash_attention.flash_attention_cuda(q, k, v), 10)
    fwd_plain_ms, _ = timed(lambda: ref.flash_attention(q, k, v), 2)
    bwd = bwd_timing(q, k, v, dout)
    res = {}
    for part in ("dq", "dkv"):
        name = f"flash_attention_bwd_{part}"
        res[name] = dict(bwd[part], max_abs_err=err)
        emit("llm_train_kernels", kernel=name, timing="main", card=smi(),
             shape=[B, S, Hq, Hkv, D], causal=True,
             plain="ref.flash_attention_bwd (dq, dk and dv)",
             library="backward of F.scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True) (dq, dk and dv)", **res[name])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        sdpa_fwd_ms, _ = timed(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    sdpa_fwd_bwd_ms, _ = timed(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), dout.transpose(1, 2)), 10)
    product = 2 * D * B * Hq * attention_pairs(S, S, True, None)  # one [pairs x D] product
    fwd_bound, fwd_by = bound(nbytes(q, k, v, q) + 4 * B * Hq * S, 2 * product)
    train_fwd = dict(ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound, bound_by=fwd_by,
                     library_ms=sdpa_fwd_ms, ops=2 * product)
    emit("llm_train_kernels", kernel="flash_attention_fwd", timing="main (training shapes)",
         card=smi(), shape=[B, S, Hq, Hkv, D], causal=True,
         library="F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)", **train_fwd)
    dq_ms, dkv_ms = bwd["dq"]["ms"], bwd["dkv"]["ms"]
    fused_ms, _ = bound(0, 5 * product)
    emit("llm_train_kernels", timing="main, whole backward and forward + backward",
         kernels_bwd_ms=dq_ms + dkv_ms, dq_ms=dq_ms, dkv_ms=dkv_ms,
         bound_ms_fused_5_products=fused_ms, plain_ms=bwd["dq"]["plain_ms"],
         library_bwd_ms=bwd["dq"]["library_ms"], kernels_fwd_bwd_ms=fwd_ms + dq_ms + dkv_ms,
         library_fwd_ms=sdpa_fwd_ms, library_fwd_bwd_ms=sdpa_fwd_bwd_ms)
    del q, k, v, dout, qt, kt, vt
    torch.cuda.synchronize()

    # hymba-1.5b's attention training shapes (25 / 5 heads of 64, group 5),
    # causal and the 1,024 window, bf16, one seed each, to the same limits
    hy = configs.get_config(HYMBA)
    B, Hq, Hkv, D = TRAIN_B, hy.n_heads, hy.n_kv_heads, hy.hd
    for label, window in (("global", None), ("local", hy.window)):
        q, k, v = flash_case(B, S, S, Hq, Hkv, D, bf, seed=51, dev=dev)
        dout = flash_case(B, S, 1, Hq, 1, D, bf, seed=52, dev=dev)[0]
        r = check_flash_bwd(f"hymba {label}", q, k, v, dout, bf, window=window)
        err = max(err, r["err"])
        del q, k, v, dout
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        res[name]["max_abs_err"] = err
    res["flash_attention_fwd"] = dict(max_abs_err=fwd_err, train=train_fwd)
    res.update(llm_train_kernels_d128(dev))

    # the SSD / mLSTM backward (no TPU kernel: ops.MlstmChunk's backward in
    # torch ops), card against CPU path, float32 and bf16 q, k, v
    ssd_err = 0.0
    for dtype in (torch.float32, bf):
        for normalize, S_, Dk, Dv in SSD_BWD_CASES:
            args = mlstm_case(2, S_, 3, Dk, Dv, normalize, dtype, seed=S_ + Dv, dev=dev)
            ssd_err = max(ssd_err, check_mlstm_bwd(f"S={S_} Dk={Dk} Dv={Dv}", args, 128,
                                                   normalize))
    res["mlstm_chunk_bwd"] = ssd_bwd_timing(hy, dev, ssd_err)
    torch.cuda.synchronize()
    return res


def token_batch(stream, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}


def train_launches_want(cfg, grad_accum: int = 1) -> dict:
    """Each LLM kernel's launches in one train step of ``cfg`` over
    ``grad_accum`` microbatches: a microbatch runs the flash forward and
    the SSD kernel once a layer that has them, twice under remat (the
    backward replays the layer), dq and dk/dv once an attention layer (the
    MoE layers' attention among them), decode attention never."""
    kinds = collections.Counter(cfg.layer_kinds)
    hy = (BlockKind.HYMBA, BlockKind.HYMBA_LOCAL)
    attn = sum(kinds[k] for k in (BlockKind.ATTN, BlockKind.ATTN_LOCAL, BlockKind.MOE) + hy)
    ssd = sum(kinds[k] for k in (BlockKind.MAMBA,) + hy)
    fwd = 2 if cfg.remat else 1
    n = grad_accum
    return {"flash_attention_fwd": n * fwd * attn, "flash_attention_bwd_dq": n * attn,
            "flash_attention_bwd_dkv": n * attn, "decode_attention": 0,
            "mlstm_chunk": n * fwd * ssd, "mlstm_chunk_tiled": 0, "mlstm_wide_state": 0,
            "mlstm_wide_out": 0}


def train_run(arch: str, steps: int, dev, n_layers=None, grad_accum: int = 1) -> dict:
    """``arch`` at full width (bf16, seeded weights, remat on; ``n_layers``
    of its layers where given): the trainer's AdamW through
    ``make_train_step`` (``grad_accum`` microbatches a step), 1 warm-up and
    ``steps`` timed steps of 8 x 2,048 tokens from the port's
    ``TokenStream``, each step's launches counted from 0 and held to
    :func:`train_launches_want`; then one step under ``torch.profiler``:
    device time by kernel and by kind (the flash kernels, the matrix
    products, the index gathers and scatters, the scans, the sorts), the
    SSD backward's and AdamW's ranges."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, S = TRAIN_B, TRAIN_S
    tcfg = llm_trainer.TrainerConfig(total_steps=steps + 2)
    opt = llm_trainer.adamw_config(tcfg)
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                           global_batch=B, seed=tcfg.seed))
    t0 = time.perf_counter()
    net = llm.init_params(tcfg.seed, cfg, device=dev)
    state = llm.init_train_state(net, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    step = llm.make_train_step(cfg, opt, grad_accum=grad_accum)

    state, metrics = step(state, token_batch(stream, dev))  # warm-up
    losses, gnorms, walls, launches = [float(metrics["loss"])], [float(metrics["grad_norm"])], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        batch = token_batch(stream, dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(llm_counts())
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"{arch} train losses {losses} / grad norms {gnorms} not finite")
    if int(state["step"]) != steps + 1:
        raise AssertionError(f"{arch} train state step {int(state['step'])}")
    want = train_launches_want(cfg, grad_accum)
    if any(n != want for n in launches):
        raise AssertionError(f"{arch} launches a step {launches}, expected {want}")
    step_s = sum(walls) / len(walls)
    run = dict(arch=arch, layers=cfg.n_layers, params=n_params, batch=B, seq=S, remat=cfg.remat,
               grad_accum=grad_accum,
               init_s=init_s, step_s_each=walls, step_s=step_s, tokens_per_s=B * S / step_s,
               losses=losses, grad_norms=gnorms, peak_memory_gb=peak / 1e9,
               launches_per_step=launches[0], launches_total={k: sum(n[k] for n in launches)
                                                              for k in want})
    emit("llm_train", card=smi(), **run)

    # device time by kernel of one step, the device's busy share of the
    # unprofiled step wall, and the SSD backward's range (torch ops)
    batch = token_batch(stream, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    averages = pr.key_averages()
    rows = device_rows(pr, averages)
    dev_s = sum(r[1] for r in rows) / 1e6
    kern = lambda tag: sum(r[1] for r in rows if tag in r[0]) / 1e6
    ssd_bwd_s = range_device_s(averages, "mlstm_chunk_bwd")
    kinds = lambda *tags: sum(r[1] for r in rows if any(t in r[0].lower() for t in tags)) / 1e6
    run["profile"] = dict(
        device_s=dev_s, wall_s=step_s, busy_share=dev_s / step_s,
        flash_fwd_s=kern("flash_fwd"), flash_bwd_dq_s=kern("flash_bwd_dq"),
        flash_bwd_dkv_s=kern("flash_bwd_dkv"), mlstm_kernel_s=kern("mlstm_"),
        mlstm_chunk_bwd_s=ssd_bwd_s,
        mlstm_chunk_bwd_share_of_device=ssd_bwd_s / dev_s if dev_s else None,
        mlstm_chunk_bwd_share_of_step=ssd_bwd_s / step_s,
        adamw_update_s=range_device_s(averages, "adamw_update"),
        products_s=kinds("gemm", "cutlass", "xmma", "nvjet"),
        index_gather_scatter_s=kinds("index", "scatter", "gather"),
        scan_s=kinds("scan"), sort_s=kinds("sort"),
        device_launches=sum(r[2] for r in rows),
        top=[[k_[:70], us / 1e6, n] for k_, us, n in rows[:12]])
    # the loss alone at a microbatch's shape, by CUDA events: the head's
    # product and the float32 cross entropy over the vocabulary, forward
    # and backward (its share of the step: once a microbatch)
    mb = B // grad_accum
    x = torch.randn((mb, S, cfg.d_model), generator=torch.Generator().manual_seed(5)).to(dev)
    x = x.to(net.head.dtype).requires_grad_()
    targets = batch["tokens"][:mb]
    loss_ms, _ = timed(lambda: torch.autograd.grad(
        cross_entropy_loss(x @ net.head, targets), (x, net.head)), 3)
    run["profile"]["loss_fwd_bwd_s_per_step"] = grad_accum * loss_ms / 1e3
    emit("llm_train", arch=arch, profile="train_step", **run["profile"])
    del net, state, step, metrics, batch, x
    torch.cuda.empty_cache()
    return run


def card_vs_cpu_step(label: str, cfg2, toks, opt, dev, step: bool = True) -> dict:
    """One float32 train step of ``cfg2`` on the card against the CPU path
    (cuBLAS and the kernels against MKL and the plain versions): gradients
    by name, then the step's loss and grad norm, to TRAIN_*_TOL. With
    ``step=False`` the loss and grad norm (the gradients' global norm, as
    the step computes it) come from the gradients' pass, which halves the
    CPU path's time."""
    t0 = time.perf_counter()
    card_net, cpu_net = seeded_pair(cfg2, dev)
    on = lambda net_: {"tokens": toks.to(net_.embed.device)}
    routes = moe_routes_card_vs_cpu(label, card_net, cpu_net, on, cfg2) \
        if BlockKind.MOE in cfg2.layer_kinds else None
    card = llm.loss_and_grads(card_net, on(card_net), cfg2)
    cpu = llm.loss_and_grads(cpu_net, on(cpu_net), cfg2)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_errs = {n: rel_err(f"{label} card vs CPU grad {n}", card[2][n].cpu(), g, TRAIN_GRAD_TOL)
                 for n, g in cpu[2].items()}
    norm = lambda grads: float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    outs = [(float(card[0]), norm(card[2])), (float(cpu[0]), norm(cpu[2]))]
    del card, cpu
    if step:
        outs = []
        for net_ in (card_net, cpu_net):
            st = llm.init_train_state(net_, opt)
            _, m = llm.make_train_step(cfg2, opt)(st, on(net_))
            outs.append((float(m["loss"]), float(m["grad_norm"])))
    step_loss_err = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
    gnorm_err = abs(outs[0][1] - outs[1][1]) / abs(outs[1][1])
    if not (loss_err <= TRAIN_LOSS_TOL and step_loss_err <= TRAIN_LOSS_TOL
            and gnorm_err <= TRAIN_GNORM_TOL):
        raise AssertionError(f"{label} card vs CPU train step: loss {loss_err}, {step_loss_err}, "
                             f"grad norm {gnorm_err}")
    worst = max(grad_errs, key=grad_errs.get)
    emit("llm_train", check=f"{label}: card vs CPU path, one float32 train step",
         layers=cfg2.n_layers, kinds=list(cfg2.layer_kinds), batch=int(toks.shape[0]),
         seq=int(toks.shape[1]), loss_rel_err=max(loss_err, step_loss_err),
         loss_tol=TRAIN_LOSS_TOL, grad_norm_rel_err=gnorm_err, grad_norm_tol=TRAIN_GNORM_TOL,
         max_grad_rel_err=grad_errs[worst], worst_grad=worst, grad_tol=TRAIN_GRAD_TOL,
         grads=len(grad_errs), loss=outs[1][0], grad_norm=outs[1][1], train_step=step,
         seconds=time.perf_counter() - t0)
    return dict(loss=max(loss_err, step_loss_err), grad_norm=gnorm_err, grad=grad_errs[worst],
                worst_grad=worst, routes=routes)


def moe_routes_card_vs_cpu(label, card_net, cpu_net, on, cfg) -> dict:
    """Each MoE layer's routing of one forward (no grad) on the card and on
    the CPU path from the same weights and tokens: the experts chosen and
    the kept pairs, compared. A router near-tie that cuBLAS and MKL round
    to different choices is reported by layer and token (not hidden by
    another seed); the gradients are then held as they come."""
    seen = {}
    for where, net_ in (("card", card_net), ("cpu", cpu_net)):
        with torch.no_grad(), moe_routes() as rs:
            llm_stack.forward(net_, on(net_), cfg)
        seen[where] = [(r.experts.cpu(), r.keep.cpu()) for r in rs]
    k = cfg.n_experts_active
    flips = []
    for i, ((e_card, keep_card), (e_cpu, keep_cpu)) in enumerate(zip(seen["card"], seen["cpu"])):
        tok = (e_card != e_cpu).any(-1) | (keep_card != keep_cpu).view(*e_cpu.shape[:2], k).any(-1)
        flips += [dict(layer=i, batch=int(b), token=int(t)) for b, t in tok.nonzero().tolist()]
    out = dict(layers=len(seen["cpu"]), tokens=int(seen["cpu"][0][0].shape[0] *
                                                     seen["cpu"][0][0].shape[1]),
               pairs_kept=[int(kp.sum()) for _, kp in seen["cpu"]],
               tokens_routed_differently=flips[:20], n_tokens_routed_differently=len(flips))
    emit("llm_train", check=f"{label}: MoE routes, card vs CPU path (float32)", **out)
    return out


def restart_check(arch: str, dev) -> None:
    """The Trainer on the card at ``arch``'s smoke config: 6 steps straight
    against 3 steps, a checkpoint, a new trainer that restores it, and 3
    more. The same ops on the same values (the checkpoint is bitwise, the
    kernels use no atomics), so the losses and weights are equal bit for
    bit."""
    import shutil
    small = configs.get_smoke_config(arch)
    root = os.path.join(ROOT, "build", "train_check")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(seq_len=64, global_batch=2, device=dev)
    mk = lambda d: llm_trainer.TrainerConfig(total_steps=6, checkpoint_every=3, warmup_steps=2,
                                             checkpoint_dir=os.path.join(root, d))
    straight = llm_trainer.Trainer(small, mk("a"), **kw).run()
    first = llm_trainer.Trainer(small, mk("b"), **kw).run(steps=3)
    second = llm_trainer.Trainer(small, mk("b"), **kw).run()
    resumed = first["losses"] + second["losses"]
    weights_equal = all(torch.equal(p, q_) for p, q_ in zip(
        straight["state"]["params"].parameters(), second["state"]["params"].parameters()))
    if resumed != straight["losses"] or second["final_step"] != 6 or not weights_equal:
        raise AssertionError(f"{arch} restart: {resumed} against {straight['losses']}, "
                             f"weights equal {weights_equal}")
    emit("llm_train", check=f"Trainer restart on the card, {arch} smoke config",
         losses_straight=straight["losses"], losses_resumed=resumed, bitwise_losses=True,
         bitwise_weights=True)
    shutil.rmtree(root, ignore_errors=True)


def phase_llm_train(dev) -> dict:
    """TinyLlama-1.1B and Hymba-1.5B at full width on the card, and
    qwen2-moe-a2.7b at full width and 2 of its 24 layers
    (:func:`train_run`: 5, 3 and 3 timed steps, qwen2-moe's as 2
    microbatches a step); one float32 step of 2 layers of each (qwen2-moe's
    of 1) against the CPU path (TinyLlama and qwen2-moe 2 x 256 tokens,
    qwen2-moe's routes compared first; Hymba one global and one windowed
    hybrid layer, 2 x 1,280 tokens, past the window and past S 256); the
    Trainer's restart continuity at the three smoke configs."""
    runs = {TINYLLAMA: train_run(TINYLLAMA, TRAIN_STEPS, dev),
            HYMBA: train_run(HYMBA, HYMBA_TRAIN_STEPS, dev),
            QWEN_MOE: train_run(QWEN_MOE, MOE_TRAIN_STEPS, dev, n_layers=MOE_TRAIN_LAYERS,
                                grad_accum=MOE_TRAIN_ACCUM)}
    opt = llm_trainer.adamw_config(llm_trainer.TrainerConfig(total_steps=TRAIN_STEPS + 2))
    tiny = configs.get_config(TINYLLAMA)
    toks = torch.randint(0, tiny.vocab_size, (2, 256), generator=torch.Generator().manual_seed(3))
    runs[TINYLLAMA]["card_vs_cpu"] = card_vs_cpu_step(
        TINYLLAMA, dataclasses.replace(tiny, n_layers=2, dtype="float32"), toks, opt, dev)
    hy = configs.get_config(HYMBA)
    toks = torch.randint(0, hy.vocab_size, (2, 1280), generator=torch.Generator().manual_seed(4))
    hy2 = dataclasses.replace(hy, n_layers=2, dtype="float32",
                              block_pattern=(BlockKind.HYMBA, BlockKind.HYMBA_LOCAL))
    runs[HYMBA]["card_vs_cpu"] = card_vs_cpu_step(HYMBA, hy2, toks, opt, dev, step=False)
    moe = configs.get_config(QWEN_MOE)
    toks = torch.randint(0, moe.vocab_size, (2, 256), generator=torch.Generator().manual_seed(6))
    moe1 = dataclasses.replace(moe, n_layers=1, dtype="float32")
    runs[QWEN_MOE]["card_vs_cpu"] = card_vs_cpu_step(QWEN_MOE, moe1, toks, opt, dev, step=False)
    for arch in (TINYLLAMA, HYMBA, QWEN_MOE):
        restart_check(arch, dev)
    torch.cuda.synchronize()
    return runs


def encdec_rows(llm_times, kernel: str, prefix: str) -> dict:
    """``kernel``'s timings at the encoder-decoder and vision shapes whose
    label starts with ``prefix``, for the ``kernels`` line."""
    keys = ("ms", "device_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    return {label: {k_: row[k_] for k_ in keys if k_ in row}
            for label, row in llm_times[f"{kernel}_encdec"].items() if label.startswith(prefix)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seconds = {}

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed_phase("build", phase_build)
    errs = timed_phase("kernels", phase_kernels, dev)
    main_run = timed_phase("main", phase_main, dev)
    bucketed = timed_phase("bucketed", phase_bucketed, dev, main_run)
    stepped = timed_phase("stepped", phase_stepped, dev, main_run)
    stream = timed_phase("stream", phase_stream, dev)
    main_run.pop("results")
    sim_serve = timed_phase("sim_serve", phase_sim_serve, dev)
    new_runs = {**bucketed["by_run"], **stepped["by_run"], **stream["by_run"],
                **sim_serve["by_run"]}
    timed_phase("parity", phase_parity, dev)
    timed_phase("profile", phase_profile, dev, main_run)
    times = timed_phase("timing", phase_timing, dev)
    mlp = timed_phase("selu_mlp", phase_selu_mlp, dev)
    cal = timed_phase("calibrate", phase_calibrate, dev)
    campaign_err = timed_phase("campaign_kernel", phase_campaign_kernel, dev)
    camp = timed_phase("campaign", phase_campaign, dev)
    sec5 = timed_phase("section5", phase_section5, dev)
    timed_phase("optimize", phase_optimize, dev)
    llm_times = timed_phase("llm_kernels", phase_llm_kernels, dev)
    serve = timed_phase("llm_serve", phase_llm_serve, dev)
    xlstm = timed_phase("llm_xlstm", phase_llm_xlstm, dev)
    moe = timed_phase("llm_moe", phase_llm_moe, dev)
    encdec = timed_phase("llm_encdec", phase_llm_encdec, dev)
    train_times = timed_phase("llm_train_kernels", phase_llm_train_kernels, dev)
    train = timed_phase("llm_train", phase_llm_train, dev)
    kernels = []
    replaces = {
        "grid_tick_bank_fused": "src/repro/kernels/grid_tick.py:477",
        "grid_tick_bank": "src/repro/kernels/grid_tick.py:242",
        # no Pallas kernel: the reference's leap step takes these sums as
        # one-hot dots (scatter_pl)
        "grid_tick_bank_sums": "src/repro/kernels/ref.py:307",
    }
    # the bank kernels and their wide instances: launches by main-path run
    # (phase main's four, the bucketed, long-tail, stepped, stream and
    # served runs)
    for name in BANK_KERNELS + WIDE_KERNELS:
        t = times[name]
        by_run = dict(main_run["by_run"].get(name, {}))
        by_run.update({run: n[name] for run, n in new_runs.items()})
        assert sum(by_run.values()) > 0, f"kernel {name} was not launched on a main path"
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/grid_tick.cu",
            replaces=replaces[name.removesuffix("_wide")], launches=sum(by_run.values()),
            launches_by_run=by_run,
            max_abs_err=max(errs.get(name, 0.0), *t["max_abs_err"].values()),
            ms=t["ms"], events_ms=t["events_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t.get("library_ms"),
            shape=t["shape"],
        ))
    # the per-campaign tick (the bank tick at S = 1) and, with no Pallas
    # kernel, the leap step's sums (the reference's one-hot dots)
    # (max abs error: the tick's against the one-hot matmul, the sums' against
    # ref.bank_sums)
    for name, timing, runs_key, src, err in (
            ("grid_tick", "timing", "launches_by_run", "src/repro/kernels/grid_tick.py:115",
             campaign_err),
            ("grid_tick_sums", "sums_timing", "sums_launches_by_run",
             "src/repro/core/engine.py:220", 0.0)):
        t = camp[timing]
        by_run = {f"campaign_{k}": n for k, n in camp[runs_key].items()}
        by_run.update({f"section5_{k}": v["launches"][name] for k, v in sec5["stages"].items()})
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/grid_tick.cu",
            replaces=src, launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=max(err, t["max_abs_err"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
        ))
    m = mlp[8192]
    by_stage = {k: cal["stages"][k]["launches"]["selu_mlp"] for k in ("train", "mcmc")}
    by_stage.update({f"section5_{k}": sec5["stages"][k]["launches"]["selu_mlp"]
                     for k in ("train", "mcmc")})
    kernels.append(dict(
        name="selu_mlp", route="cuda", source="src/repro_torch/kernels/csrc/selu_mlp.cu",
        replaces="src/repro/kernels/selu_mlp.py:64", launches=sum(by_stage.values()),
        launches_by_run=by_stage,
        max_abs_err=max(v["max_abs_err"] for v in mlp.values()),
        ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=None, bound_ms_no_fma=m["bound_ms_no_fma"], device_ms=m["device_ms"],
        section5_shape={k_: mlp[4][k_] for k_ in ("ms", "device_ms", "bound_ms", "bound_ms_no_fma")},
    ))
    llm_replaces = {
        "flash_attention_fwd": "src/repro/kernels/flash_attention.py:122",
        "decode_attention": "src/repro/kernels/decode_attention.py:99",
        "mlstm_chunk": "src/repro/kernels/mlstm_chunk.py:236",
    }
    for name, src in (("flash_attention_fwd", "flash_attention.cu"),
                      ("decode_attention", "decode_attention.cu"),
                      ("mlstm_chunk", "mlstm_chunk.cu")):
        t = llm_times[name]
        by_run = {run: n[name] for run, n in serve["launches_by_run"].items()}
        extra = {}
        if name in ("flash_attention_fwd", "mlstm_chunk"):
            for arch, n_steps in ((TINYLLAMA, TRAIN_STEPS), (HYMBA, HYMBA_TRAIN_STEPS)):
                by_run[f"{arch}_train_{n_steps}_steps"] = train[arch]["launches_total"][name]
        if name != "mlstm_chunk":  # seamless-m4t-large-v2's runs: every launch at head dim 64
            by_run.update({f"{SEAMLESS}_{run}": n[name] for run, n in
                           encdec[SEAMLESS]["serve"]["launches_by_run"].items()})
            extra["encdec_shapes"] = encdec_rows(llm_times, name, "seamless")
        if name == "flash_attention_fwd":
            extra.update({f"{k_}_training_shapes": v_ for k_, v_ in
                          train_times[name]["train"].items()
                          if k_ in ("ms", "bound_ms", "library_ms")})
        if name == "mlstm_chunk":  # its backward: torch ops, no TPU kernel
            extra = {"backward_torch_ops": train_times["mlstm_chunk_bwd"]}
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=llm_replaces[name], launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=max(t["max_abs_err"], train_times.get(name, t)["max_abs_err"],
                            llm_times.get(f"{name}_encdec", t)["max_abs_err"]),
            ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"], **extra,
        ))
    # the flash forward's and decode attention's width-128 instances:
    # qwen2-moe-a2.7b's prefill and decode runs (every launch there is at
    # head dim 128)
    for name, kernel, src in (
            ("flash_attention_fwd_d128", "flash_attention_fwd", "flash_attention.cu"),
            ("decode_attention_d128", "decode_attention", "decode_attention.cu")):
        t = llm_times[name]
        by_run = {f"{QWEN_MOE}_{run}": n[kernel]
                  for run, n in moe["serve"]["launches_by_run"].items()}
        by_run.update({f"{INTERNVL}_{run}": n[kernel]  # internvl2-2b: every launch at D 128
                       for run, n in encdec[INTERNVL]["serve"]["launches_by_run"].items()})
        extra = {"encdec_shapes": encdec_rows(llm_times, kernel, "internvl2")}
        if kernel == "flash_attention_fwd":  # qwen2-moe's train run: every launch at D 128
            by_run[f"{QWEN_MOE}_train_{MOE_TRAIN_STEPS}_steps"] = \
                train[QWEN_MOE]["launches_total"][kernel]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=llm_replaces[kernel], launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=max(t["max_abs_err"], llm_times[f"{kernel}_encdec"]["max_abs_err"]),
            ms=t["ms"], device_ms=t.get("device_ms"), **extra,
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            dense_configs={a: {k_: t[a][k_] for k_ in ("ms", "bound_ms", "library_ms")}
                           for a in DENSE_D128},
        ))
    # past Dk 64: the tensor-core pair on xlstm-350m's prefill and decode
    # runs (bf16), the Dk-tiled kernel on the float32 card-vs-CPU run
    t = xlstm["wide"]
    for name in ("mlstm_wide_state", "mlstm_wide_out"):
        k = t["kernels"][name]
        by_run = {f"{XLSTM}_{run}": n[name] for run, n in xlstm["serve"]["launches_by_run"].items()}
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/mlstm_chunk.cu",
            replaces=llm_replaces["mlstm_chunk"], launches=sum(by_run.values()),
            launches_by_run=by_run, max_abs_err=t["max_abs_err"], max_rel_err=t["max_rel_err"],
            ms=k["device_ms"], pair_ms_events=t["ms"], plain_ms=t["plain_ms"],
            plain_of="the whole cell (ref.mlstm_chunk_chunked)", bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], cell_bound_ms=t["bound_ms"], library_ms=t["library_ms"],
        ))
    t = xlstm["tiled"]
    kernels.append(dict(
        name="mlstm_chunk_tiled", route="cuda", source="src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        replaces=llm_replaces["mlstm_chunk"], launches=xlstm["float32_launches"]["mlstm_chunk_tiled"],
        launches_by_run={f"{XLSTM}_float32_card_vs_cpu": xlstm["float32_launches"]["mlstm_chunk_tiled"],
                         **{f"{XLSTM}_{run}": n["mlstm_chunk_tiled"]
                            for run, n in xlstm["serve"]["launches_by_run"].items()}},
        max_abs_err=t["max_abs_err"], max_rel_err=t["max_rel_err"], ms=t["ms"],
        device_ms=t["device_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"], dtype="float32",
    ))
    # the backward's kernels: the width-64 instances on TinyLlama's and
    # Hymba's train runs, the width-128 ones on qwen2-moe's (every launch
    # there at head dim 128)
    for name, line, archs in (
            ("flash_attention_bwd_dq", 287, (TINYLLAMA, HYMBA)),
            ("flash_attention_bwd_dkv", 329, (TINYLLAMA, HYMBA)),
            ("flash_attention_bwd_dq_d128", 287, (QWEN_MOE,)),
            ("flash_attention_bwd_dkv_d128", 329, (QWEN_MOE,))):
        t, kernel = train_times[name], name.removesuffix("_d128")
        extra = {"dense_configs": t["dense_configs"]} if "dense_configs" in t else {}
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            launches=sum(train[a]["launches_total"][kernel] for a in archs),
            launches_by_run={f"{a}_train_step": train[a]["launches_per_step"][kernel]
                             for a in archs},
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"], **extra,
        ))
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
