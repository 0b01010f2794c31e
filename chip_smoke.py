"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile every CUDA source under ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (all at once) and load it;
2. kernels — each kernel against its plain PyTorch version on the card, on a
   7-family bank (bank-wide and per-replica keep/mu/sigma);
3. main    — ``Fleet.from_scenarios(n=1024).run(replicas=64)`` (65,536
   elements) in tick and leap mode, default and stochastic params, with the
   kernels' launch counts of each timed run (counts set to 0 just before
   it, read just after);
4. parity  — bitwise window invariance (K=1 vs K=64) on 64 scenarios x 4
   replicas; the card's normals bitwise against the CPU path's (200,000
   keys x 11); the card's ``Fleet.run`` against the CPU path on a small
   bank, default and stochastic (``bg_mu=2, bg_sigma=1.5``) params;
5. profile — device time by kernel of one tick and one leap main-path run
   under ``torch.profiler``, and the device's busy share;
6. timing  — each grid-tick kernel and its plain version at the main
   path's shapes: the outputs held against each other, the times taken
   with CUDA events, beside the least time the card could take;
7. calibrate — the SELU-MLP kernel against its plain version at the
   calibration path's shapes (forward and backward), timed beside its
   bound; then the amortized calibration path at full width,
   ``Fleet.from_scenarios(n=1024).calibrate(x_true, key,
   CalibrationConfig(), amortized=True)`` (65,536 presimulated tuples, 30
   epochs of the 4x128 classifier at batch 4,096), ``theta_star_all`` over
   every scenario (8,192 chains) and ``Fleet.validate``, with each stage's
   seconds and kernel launches (counts set to 0 just before a stage, read
   just after); the device time per MCMC and training step under
   ``torch.profiler``; and a 200-step chain on the card against the CPU
   path.

Then the ``kernels`` line, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import CalibrationConfig, Fleet  # noqa: E402
from repro_torch.convert import classifier_from_reference, classifier_to_reference  # noqa: E402
from repro_torch.core import calibration, classifier, engine, mcmc, prng  # noqa: E402
from repro_torch.core.scenarios import build_bank  # noqa: E402
from repro_torch.kernels import _build, grid_tick, ops, ref, selu_mlp  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# plain vs kernel: integer and bool fields equal; float fields whose sums
# run in another order (matmul vs ascending segment sums) within these
RTOL, ATOL = 1e-5, 1e-4

N_SCEN, N_REP = 1024, 64
# the calibration path's classifier: 3 theta + 3 x + 9 context features in,
# 4 hidden SELU layers of 128, one logit out
MLP_IN, MLP_HIDDEN, MLP_DEPTH = 15, 128, 4
THETA_TRUE = (0.05, 40.0, 20.0)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi() -> str:
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
        state = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=warm)
        state = (state[0], torch.zeros_like(state[1])) + tuple(state[2:])
    noise = torch.randn((K, S, R, L), generator=g).to(dev)
    return state, mu, sigma, consts, noise


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build()
    limits = grid_tick.limits()
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         built=sorted(built), max_legs_procs_links=list(limits),
         selu_mlp_max_hidden_in_out_depth=list(selu_mlp.limits()), card=smi(),
         ptxas={k: [ln for ln in v.splitlines() if "Used" in ln]
                for k, v in _build.build_logs.items()})
    return {"seconds": time.perf_counter() - t0}


def phase_kernels(dev) -> dict:
    bank = build_bank(n=64, seed=0)
    R, K = 8, 16
    errs = {"grid_tick_bank_fused": 0.0, "grid_tick_bank": 0.0}
    for per_replica in (False, True):
        state, mu, sigma, consts, noise = window_inputs(bank, R, K, dev, per_replica)
        want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise)
        got = ops.grid_tick_bank_fused(state, mu, sigma, *consts, window=K, noise=noise)
        fields = {}
        for name, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want):
            fields[name] = compare(f"fused {name}", g_, w_, exact=False)
        errs["grid_tick_bank_fused"] = max(errs["grid_tick_bank_fused"], *fields.values())
        emit("kernels", kernel="grid_tick_bank_fused", per_replica=per_replica,
             S=bank.n_scenarios, R=R, K=K, max_abs_err=fields,
             alive_steps=int(got[1].sum()))

        # one tick at the same state: a random active set over unfinished legs
        g = torch.Generator(device="cpu").manual_seed(1)
        done, remaining, bg = state[3], state[2], state[9]
        active = ((torch.rand(done.shape, generator=g).to(dev) < 0.7) & ~done).float()
        keep = consts[4]
        lp, pl, ll = consts[6], consts[7], consts[8]
        keep3 = keep if keep.dim() == 3 else keep[:, None]
        want = ref.grid_tick(active, remaining, keep3, bg, consts[5][:, None],
                             lp[:, None], pl[:, None], ll[:, None])
        got = ops.grid_tick_bank(active, remaining, keep, bg, consts[5], lp, pl, ll)
        fields = {n: compare(f"tick {n}", g_, w_, exact=False)
                  for n, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want)}
        errs["grid_tick_bank"] = max(errs["grid_tick_bank"], *fields.values())
        emit("kernels", kernel="grid_tick_bank", per_replica=per_replica,
             S=bank.n_scenarios, R=R, max_abs_err=fields)
    torch.cuda.synchronize()
    return errs


def phase_main(dev) -> dict:
    """The four timed runs (tick/leap x default/stochastic), each after an
    uncounted warm-up. ``launches`` sums the four runs' counts."""
    fleet = Fleet.from_scenarios(n=N_SCEN, seed=0, device=dev)
    runs = []
    for leap in (False, True):
        for label, kw in (("default", {}), ("stochastic", dict(bg_mu=2.0, bg_sigma=1.0))):
            params = fleet.params(**kw)
            fleet.run(params, replicas=N_REP, leap=leap)  # warm-up
            torch.cuda.synchronize()
            engine.STATS["windows"] = 0
            grid_tick.reset_launches()
            t0 = time.perf_counter()
            res = fleet.run(params, replicas=N_REP, leap=leap)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(grid_tick.LAUNCHES)
            shape = (N_SCEN, N_REP, fleet.pads[0])
            for f in ("transfer_time", "conth_mb", "conpr_mb", "start_tick"):
                x = getattr(res, f)
                assert tuple(x.shape) == shape, (f, tuple(x.shape))
                assert bool(torch.isfinite(x).all()), f"{f} not finite"
            assert bool((res.transfer_time >= 0).all()), "negative transfer_time"
            valid = torch.as_tensor(fleet.bank.leg_valid, device=dev)[:, None, :]
            run = dict(
                mode="leap" if leap else "tick", params=label, wall_s=wall,
                elements=N_SCEN * N_REP, elements_per_s=N_SCEN * N_REP / wall,
                windows=engine.STATS["windows"],
                realized_ticks=int(res.ticks.max()),
                done_share=float((res.done & valid).sum() / valid.expand_as(res.done).sum()),
                launches=launches,
            )
            emit("main", **run)
            runs.append(run)
    launches = {k: sum(r["launches"][k] for r in runs) for k in grid_tick.LAUNCHES}
    by_run = {k: {f"{r['mode']}_{r['params']}": r["launches"][k] for r in runs}
              for k in grid_tick.LAUNCHES}
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    emit("main", pads=list(fleet.pads), launches=launches, launches_by_run=by_run)
    return {"launches": launches, "by_run": by_run, "runs": runs}


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


def device_rows(prof):
    """``(name, device us, count)`` of a profile's device-side events
    (kernels, copies), largest first: the CPU-side op events carry their
    kernels' time too and would count it twice."""
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    return sorted(
        ((e.key, dev_us(e), e.count) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
        key=lambda r: -r[1],
    )


def profile_steps(fn, steps: int, wall_per_step: float) -> dict:
    """Device time per step of ``fn()`` (``steps`` steps) under
    ``torch.profiler``, beside the unprofiled wall per step of the same
    stage: their ratio is the device's busy share there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fleet.run(replicas=N_REP, leap=leap)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total_s = sum(r[1] for r in rows) / 1e6
        wall = walls[(mode, "default")]
        fused = sum(r[1] for r in rows if "bank_fused_kernel" in r[0]) / 1e6
        tick = sum(r[1] for r in rows if "bank_tick_kernel" in r[0]) / 1e6
        out[mode] = dict(
            device_s=total_s, wall_s=wall,
            busy_share=total_s / wall if total_s else None,
            grid_tick_kernels_s=fused + tick,
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


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def phase_timing(dev) -> dict:
    """Each kernel and its plain version on the main path's inputs: the
    fused kernel over one K=32 window of the stochastic tick run's first
    carry, the one-tick kernel with ``remaining = inf`` as the leap scan
    calls it. The outputs are held against each other, then timed."""
    bank = build_bank(n=N_SCEN, seed=0)
    S, R, K = N_SCEN, N_REP, 32
    T, P, L = bank.pad_legs, bank.pad_procs, bank.pad_links
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    mu, sigma = p.bg_mu[:, None], p.bg_sigma[:, None]
    consts = (spec.release, spec.dep, spec.bg_period, spec.max_ticks, p.keep_frac,
              spec.bandwidth, spec.leg_proc, spec.proc_link, spec.leg_link)
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64, device=dev))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.randn((K, S, R, L), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tables = spec.index_tables
    f32 = torch.float32
    args = (state, noise, mu.contiguous(), sigma.contiguous(), *consts[:5], consts[5], *tables)
    fused_ms, got = timed(lambda: grid_tick.grid_tick_bank_fused_cuda(*args), 20)
    alive_steps = int(got[1].sum())
    plain_fused_ms, want = timed(lambda: ref.grid_tick_bank_window(
        state, mu, sigma, *consts, leap=False, noise=noise), 2)
    fused_errs = {name: compare(f"fused {name} at main shapes", g_, w_, exact=False)
                  for name, g_, w_ in zip(ref.BANK_WINDOW_STATE_FIELDS, got, want)}
    # bytes: carry in and out once, the window's noise, the scenario tables
    fused_bytes = 2 * nbytes(*state) + nbytes(noise, mu, sigma, *consts[:6], *tables)
    # fp32 operations per alive element-tick: ~14 per leg (share, sums,
    # accumulators) and ~5 per link (resample, fair-share denominator)
    fused_ops = alive_steps * (14 * T + 5 * L)
    fused_bound = max(fused_bytes / PEAK_BYTES, fused_ops / PEAK_FP32) * 1e3
    fused_by = "bytes" if fused_bytes / PEAK_BYTES >= fused_ops / PEAK_FP32 else "operations"

    g = torch.Generator(device="cpu").manual_seed(2)
    active = (torch.rand((S, R, T), generator=g) < 0.5).to(dev).to(f32) * spec.leg_valid[:, None].to(f32)
    remaining = torch.full((S, R, T), float("inf"), dtype=f32, device=dev)
    bg = torch.rand((S, R, L), generator=g).to(dev)
    keep = p.keep_frac.contiguous()
    targs = (active, remaining, keep, bg, spec.bandwidth.to(f32), *tables)
    tick_ms, got = timed(lambda: grid_tick.grid_tick_bank_cuda(*targs), 50)
    keep3 = keep[:, None]
    plain_tick_ms, want = timed(lambda: ref.grid_tick(
        active, remaining, keep3, bg, spec.bandwidth[:, None], spec.leg_proc[:, None],
        spec.proc_link[:, None], spec.leg_link[:, None]), 5)
    tick_errs = {n: compare(f"tick {n} at main shapes", g_, w_, exact=False)
                 for n, g_, w_ in zip(("xfer", "proc_xfer", "link_xfer"), got, want)}
    tick_bytes = nbytes(active, remaining, keep, bg, spec.bandwidth, *tables) + 4 * S * R * (T + P + L)
    tick_ops = S * R * (14 * T + 5 * L)
    tick_bound = max(tick_bytes / PEAK_BYTES, tick_ops / PEAK_FP32) * 1e3
    tick_by = "bytes" if tick_bytes / PEAK_BYTES >= tick_ops / PEAK_FP32 else "operations"
    res = {
        "grid_tick_bank_fused": dict(ms=fused_ms, plain_ms=plain_fused_ms, bound_ms=fused_bound,
                                     bound_by=fused_by, bytes=fused_bytes, ops=fused_ops,
                                     shape=[K, S, R, T, P, L], alive_steps=alive_steps,
                                     max_abs_err=fused_errs),
        "grid_tick_bank": dict(ms=tick_ms, plain_ms=plain_tick_ms, bound_ms=tick_bound,
                               bound_by=tick_by, bytes=tick_bytes, ops=tick_ops,
                               shape=[S, R, T, P, L], max_abs_err=tick_errs),
    }
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
    path's shapes: N = 8,192 (every scenario's chains in one MCMC step) and
    N = 4,096 (a training batch), F_in = 15. Forward outputs and
    pre-activations within rtol/atol 1e-5 (the same ascending sums; expm1
    may round differently); the autograd gradients of the BCE loss within
    1e-4 of each tensor's largest entry (sums over the batch in torch
    matmuls, from slightly different forwards). The forward is timed at
    both sizes; the kernel line carries the MCMC shape."""
    out = {}
    for n in (8192, 4096):
        x, ws, bs = mlp_net(n, MLP_IN, dev, seed=n)
        got, pre = selu_mlp.selu_mlp_cuda(x, ws, bs, save_pre=True)
        want, want_pre = ref.selu_mlp(x, ws, bs, return_pre=True)
        err = max(compare(f"selu_mlp N={n} out", got, want, False, 1e-5, 1e-5),
                  compare(f"selu_mlp N={n} pre", pre, want_pre, False, 1e-5, 1e-5))
        g_k = mlp_grads(ops.selu_mlp, x, ws, bs)
        g_p = mlp_grads(lambda a, w, b: ref.selu_mlp(a, w, b), x, ws, bs)
        grad_rel = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        if grad_rel > 1e-4:
            raise AssertionError(f"selu_mlp N={n} gradients differ: {grad_rel} of the largest entry")
        ms, _ = timed(lambda: selu_mlp.selu_mlp_cuda(x, ws, bs), 200)
        plain_ms, _ = timed(lambda: ref.selu_mlp(x, ws, bs), 3)
        # operations: a multiply and an add per weight per row; bytes: the
        # input rows and weights read once, the logits written once
        ops_ = 2 * n * (MLP_IN * MLP_HIDDEN + (MLP_DEPTH - 1) * MLP_HIDDEN ** 2 + MLP_HIDDEN)
        bytes_ = nbytes(x, *ws, *bs) + 4 * n
        bound = max(bytes_ / PEAK_BYTES, ops_ / PEAK_FP32) * 1e3
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes" if bytes_ / PEAK_BYTES >= ops_ / PEAK_FP32 else "operations",
                      ops=ops_, bytes=bytes_, max_abs_err=err, grad_max_rel_err=grad_rel)
        emit("calibrate", check="selu_mlp kernel vs plain", N=n, F_in=MLP_IN, card=smi(),
             library_ms=None, library="none: no single PyTorch call computes the SELU MLP",
             **out[n])
    torch.cuda.synchronize()
    return out


def reset_counts() -> None:
    grid_tick.reset_launches()
    selu_mlp.reset_launches()


def counts() -> dict:
    return {**grid_tick.LAUNCHES, **selu_mlp.LAUNCHES}


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
    for name, want in (("calibrate", ("selu_mlp", "grid_tick_bank")), ("mcmc", ("selu_mlp",)),
                       ("validate", ("grid_tick_bank",))):
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

    # where the time goes: a 501-step MCMC over every scenario's chains and
    # two training epochs on the presimulated tuples, profiled
    prof = {}
    prof["mcmc"] = profile_steps(
        lambda: post.theta_star_all(prng.PRNGKey(1, dev), n_samples=400, burn_in=100),
        501, stages["mcmc"]["seconds"] / (mcmc_steps + 1))
    theta_u = calibration.PriorBox.paper(dev).to_unit(theta)
    x_lo, x_hi = (torch.tensor(v, device=dev) for v in (cfg.x_low, cfg.x_high))
    x_u = torch.clamp((x_sim - x_lo) / (x_hi - x_lo), 0.0, 1.0)
    train_steps = cfg.epochs * -(-theta.shape[0] // cfg.batch_size)
    prof["train"] = profile_steps(
        lambda: classifier.train_classifier(
            prng.PRNGKey(5, dev), classifier.ClassifierConfig(context_dim=post.n_features, lr=cfg.lr),
            theta_u, x_u, post.features[sid.long()], epochs=2, batch_size=cfg.batch_size),
        2 * train_steps // cfg.epochs, stages["train"]["seconds"] / train_steps)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    errs = phase_kernels(dev)
    main_run = phase_main(dev)
    phase_parity(dev)
    phase_profile(dev, main_run)
    times = phase_timing(dev)
    mlp = phase_selu_mlp(dev)
    cal = phase_calibrate(dev)
    kernels = []
    replaces = {
        "grid_tick_bank_fused": "src/repro/kernels/grid_tick.py:477",
        "grid_tick_bank": "src/repro/kernels/grid_tick.py:242",
    }
    for name in ("grid_tick_bank_fused", "grid_tick_bank"):
        t = times[name]
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/grid_tick.cu",
            replaces=replaces[name], launches=main_run["launches"][name],
            launches_by_run=main_run["by_run"][name],
            max_abs_err=max(errs[name], *t["max_abs_err"].values()),
            ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        ))
    m = mlp[8192]
    by_stage = {k: cal["stages"][k]["launches"]["selu_mlp"] for k in ("train", "mcmc")}
    kernels.append(dict(
        name="selu_mlp", route="cuda", source="src/repro_torch/kernels/csrc/selu_mlp.cu",
        replaces="src/repro/kernels/selu_mlp.py:64", launches=sum(by_stage.values()),
        launches_by_run=by_stage,
        max_abs_err=max(v["max_abs_err"] for v in mlp.values()),
        ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=None,
    ))
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
