"""Time kernels of this checkout beside the same kernels built from another
checkout's sources, in one process on one card, and check that both agree
with the plain versions.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    mkdir -p build/other && git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/other
    python3 tools/ab_kernels.py --other build/other/src/repro_torch/kernels/csrc

Groups (``--groups``, default all):

- ``bank``: the banked simulator's fused window (one K = 32 window of the
  stochastic tick run's first carry), one tick (``remaining = inf`` as the
  leap scan calls it) and the sums of its transfers: first on their wide
  instances (``bank_fused_wide_kernel``, ``bank_tick_wide_kernel``,
  ``bank_sums_wide_kernel``) at the long-tail fleet's widest bucket (S 3,
  R 64, T 196, P 196, L 2) and at the serving bench's widest slot bank (T
  256, P 256, L 8), then (``bank_fused_kernel``, ``bank_tick_kernel``,
  ``bank_sums_kernel``) at the main path's shapes (1,024 scenarios x 64
  replicas). Both builds run through this checkout's wrappers (the other's
  library swapped in), so the other sources must export the same C
  signatures of the three launches (commit 593f029 does); both bitwise
  against the plain versions and each other.
- ``campaign``: one per-campaign tick at its main shape (B = 2,048
  simulations of the Section-5 campaign, one keep per row, ``remaining =
  inf`` as presimulation's leap calls it). This build runs
  ``bank_tick_kernel`` at S = 1, bitwise against ``ref.grid_tick_indexed``;
  the other is commit 593f029's ``campaign_tick_kernel``, called with its own
  C signature (``grid_tick_campaign_launch`` on its own packed CSR tables)
  and held within chip_smoke's RTOL/ATOL (its link sums walk the legs).
  Then the leap step's sums of that tick's transfers (``bank_sums_kernel``
  at S = 1, bitwise against ``ref.bank_sums``) beside the one-hot matmul
  that commit 593f029's leap step ran in its place.
- ``selu_mlp``: called with this checkout's C signature, so the other
  sources must export the same (commit 386eef2 does).
- ``mlstm_chunk``: the SSD kernel at hymba-1.5b's serving shape (bf16), then
  xlstm-350m's prefill shape (B 8, S 2,048, H 4, Dk = Dv = 512, chunk 128,
  normalize): in bf16 this build's tensor-core pair against the other's
  kernel (the Dk-tiled one before the pair), both within 8e-3 of
  ``ref.mlstm_chunk_chunked``, timed in turns; in float32 (the Dk-tiled
  kernel in both) every output bitwise the other's, at that shape and on
  ``chip_smoke.py``'s ``TILED_CASES``. The other's ``mlstm_chunk_launch``
  is called with its own C signature: this checkout's where it exports
  ``mlstm_chunk_scratch_floats``, else the one without the scratch
  argument (commits 386eef2 to 152b846).
- ``flash``: the flash-attention forward and backward (dq, then dk/dv) at
  head dims up to 64, called with this checkout's C signatures of
  ``flash_attention_fwd_launch``, ``flash_attention_bwd_dq_launch`` and
  ``flash_attention_bwd_dkv_launch`` (unchanged since commit 386eef2): on
  ``chip_smoke.py``'s ragged cases (float32 and bf16, pointers off 16 bytes
  too), at hymba-1.5b's serving shapes (bf16, global and the 1,024 window)
  and at tinyllama-1.1b's training shape (bf16, B 8, S 2,048, 32 / 4
  heads), both builds' out and lse, then dq, delta, dk and dv (each build's
  backward on this build's out and lse) held bitwise to each other
  (``bitwise_other``), the forward within ``chip_smoke.py``'s limits of
  the plain version; the serving shapes' forward and the training shape's
  dq and dk/dv timed.

Each kernel is timed as device time under ``torch.profiler``
(``chip_smoke.device_ms``) in turns: other, this, this, other (the bank
groups also by CUDA events, ``events``). One JSON line per shape, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.scenarios import build_bank  # noqa: E402
from repro_torch.kernels import _build, flash_attention, grid_tick, mlstm_chunk, ref, selu_mlp  # noqa: E402

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# the per-campaign launch's C signature at commit 593f029
OLD_CAMPAIGN_ARGTYPES = [P] * 3 + [I] + [P] * 3 + [I] + [P] * 3 + [I] * 4 + [P]
# mlstm_chunk_launch without the scratch argument (commits 386eef2 to 152b846)
OLD_MLSTM_ARGTYPES = [P] * 6 + [I] * 7 + [F] * 3 + [I, P]


def build_other(csrc: str, out_dir: str, names) -> dict:
    """Build the other checkout's sources with this checkout's flags, every
    ``nvcc`` at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"),
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names
    }
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"other {name}.cu did not build:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    if "selu_mlp" in libs:
        libs["selu_mlp"].selu_mlp_launch.argtypes = selu_mlp._lib().selu_mlp_launch.argtypes
    if "mlstm_chunk" in libs:
        other = libs["mlstm_chunk"]
        other.scratch = hasattr(other, "mlstm_chunk_scratch_floats")
        if other.scratch:
            ours = mlstm_chunk._lib().mlstm_chunk_scratch_floats
            other.mlstm_chunk_scratch_floats.argtypes = ours.argtypes
            other.mlstm_chunk_scratch_floats.restype = ours.restype
        other.mlstm_chunk_launch.argtypes = (mlstm_chunk._lib().mlstm_chunk_launch.argtypes
                                             if other.scratch else OLD_MLSTM_ARGTYPES)
    if "flash_attention" in libs:
        for fn in ("flash_attention_fwd_launch", "flash_attention_bwd_dq_launch",
                   "flash_attention_bwd_dkv_launch"):
            getattr(libs["flash_attention"], fn).argtypes = \
                getattr(flash_attention._lib(), fn).argtypes
    if "grid_tick" in libs:
        ours, other = grid_tick._lib(), libs["grid_tick"]
        for fn in ("grid_tick_bank_fused_launch", "grid_tick_bank_launch", "grid_tick_bank_sums_launch",
                   "grid_tick_limits", "grid_tick_campaign_limits"):
            getattr(other, fn).argtypes = getattr(ours, fn).argtypes
        if hasattr(other, "grid_tick_campaign_launch"):
            other.grid_tick_campaign_launch.argtypes = OLD_CAMPAIGN_ARGTYPES
    return libs


def through(lib, fn):
    """``fn()`` with the grid-tick wrappers launching from ``lib``."""
    def call():
        saved = grid_tick._lib
        grid_tick._lib = lambda: lib
        try:
            return fn()
        finally:
            grid_tick._lib = saved
    return call


def held(label, got, want, names, exact: bool) -> float:
    return max(cs.compare(f"{label} {n}", g, w, exact=exact) for n, g, w in zip(names, got, want))


def ab_window(label, spec, p, R, other_lib, dev, reps) -> None:
    """One K = 32 window of the fused kernel (``chip_smoke.first_window``),
    one tick (``remaining = inf``, ``chip_smoke.tick_inputs``) and the sums
    of its transfers on ``spec`` x ``R`` replicas: each build bitwise the
    plain versions and the other build, then timed in turns by device time
    and by CUDA events. ``reps`` calls a timing of the fused, tick and sums
    kernels."""
    S, T = spec.size_mb.shape
    P, L = spec.leg_proc.shape[-1], spec.bandwidth.shape[-1]
    state, noise, mu, sigma, consts = cs.first_window(spec, p, R, dev)
    tables = spec.bank_tables
    want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                     tables=tables)
    targs = cs.tick_inputs(spec, p, R, dev)
    active, remaining, keep, bg = targs[:4]
    want_tick = ref.grid_tick_bank_indexed(active, remaining, keep, bg, spec.bandwidth,
                                           spec.leg_proc, spec.proc_link, tables)
    v = want_tick[0]
    calls = (
        ("bank_fused", lambda: grid_tick.grid_tick_bank_fused_cuda(state, noise, mu, sigma,
                                                                   *consts[:6], tables),
         want, ref.BANK_WINDOW_STATE_FIELDS, [32, S, R, T, P, L]),
        ("bank_tick", lambda: grid_tick.grid_tick_bank_cuda(*targs), want_tick,
         ("xfer", "proc_xfer", "link_xfer"), [S, R, T, P, L]),
        ("bank_sums", lambda: grid_tick.grid_tick_bank_sums_cuda(v, tables), want_tick[1:],
         ("proc", "link"), [S, R, T, P, L]),
    )
    for (tag, this, plain, names, shape), n in zip(calls, reps):
        other = through(other_lib, this)
        got_this, got_other = this(), other()
        row = dict(kernel=tag, case=label, shape=shape,
                   this_bitwise=held(f"this {tag}", got_this, plain, names, exact=True) == 0.0,
                   other_bitwise=held(f"other {tag}", got_other, plain, names, exact=True) == 0.0,
                   bitwise_other=all(torch.equal(a, b) for a, b in zip(got_this, got_other)))
        if tag == "bank_fused":
            row["alive_steps"] = int(plain[1].sum())
        row.update(turns(other, this, n, tag))
        row["events"] = event_turns(other, this, n)
        print(json.dumps(row), flush=True)
        if not row["bitwise_other"]:
            raise AssertionError(f"{tag} {label}: this build's bits differ from the other's")


def ab_bank(other_lib, dev) -> None:
    """The bank kernels' wide instances at the long-tail fleet's widest
    bucket and at the serving bench's widest slot bank, then the bank
    kernels at the main path's shapes (1,024 scenarios x 64 replicas)."""
    ab_window("long_tail_widest", *cs.widest_long_tail(dev), other_lib, dev, (20, 50, 50))
    ab_window("serve_256", *cs.serve_wide_bank(dev), other_lib, dev, (20, 50, 50))
    bank = build_bank(n=cs.N_SCEN, seed=0)
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    ab_window("main", spec, p, cs.N_REP, other_lib, dev, (5, 50, 50))


def old_campaign_tables(lp, pl, ll) -> torch.Tensor:
    """Commit 593f029's packed per-campaign tables: ``proc_of_leg |
    link_of_leg | proc_ptr | proc_legs | link_ptr | link_legs |
    link_proc_ptr | link_procs``, each list a CSR pair over the nonzeros
    of an incidence by column, rows ascending."""
    def csr(m):
        nz = (m != 0).t()
        ptr = torch.zeros(nz.shape[0] + 1, dtype=torch.int64, device=m.device)
        ptr[1:] = torch.cumsum(nz.sum(dim=1), 0)
        return [ptr, torch.nonzero(nz)[:, 1]]
    cols = [torch.argmax(lp, dim=-1), torch.argmax(ll, dim=-1)]
    return torch.cat([*cols, *csr(lp), *csr(ll), *csr(pl)]).to(torch.int32).contiguous()


def old_campaign_call(lib, a, rem, keep, bg, bw, packed, P):
    """One tick of the other build's ``campaign_tick_kernel``, as its
    wrapper launched it at commit 593f029."""
    B, T = a.shape
    L = bw.shape[0]
    outs = [torch.empty((B, n), device=a.device) for n in (T, P, L)]
    err = lib.grid_tick_campaign_launch(
        a.data_ptr(), rem.data_ptr(), keep.data_ptr(), T if keep.dim() == 2 else 0, bg.data_ptr(),
        bw.data_ptr(), packed.data_ptr(), packed.numel(), *(o.data_ptr() for o in outs),
        B, T, P, L, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"campaign launch failed: {err}")
    return outs


def ab_campaign(other_lib, dev) -> None:
    """B.3's tick at its main shape, this build against commit 593f029's."""
    spec = engine.SimSpec.from_table(cs.section5_table(), max_ticks=cs.SECTION5_MAX_TICKS,
                                     device=dev)
    T, P, L = spec.n_legs, spec.leg_proc.shape[1], spec.n_links
    a, rem, keep, bg = cs.campaign_tick_inputs(cs.CAMPAIGN_B, T, L, dev, per_row=True, inf=True)
    tables = spec.campaign_tables
    want = ref.grid_tick_indexed(a, rem, keep, bg, spec.bandwidth, spec.leg_proc, spec.proc_link,
                                 tables)
    packed = old_campaign_tables(spec.leg_proc, spec.proc_link, spec.leg_link)
    names = ("xfer", "proc_xfer", "link_xfer")
    this = lambda: grid_tick.grid_tick_cuda(a, rem, keep, bg, spec.bandwidth, tables)
    other = lambda: old_campaign_call(other_lib, a, rem, keep, bg, spec.bandwidth, packed, P)
    row = dict(kernel="campaign tick", shape=[cs.CAMPAIGN_B, T, P, L],
               this_bitwise=held("this campaign", this(), want, names, exact=True) == 0.0,
               other_max_abs_err=held("other campaign", other(), want, names, exact=False))
    row.update(turns(other, this, 200, "bank_tick_kernel", other_tag="campaign_tick_kernel"))
    print(json.dumps(row), flush=True)

    # the leap step's sums of the tick's transfers, beside the one-hot
    # matmul they replace (as the other checkout's leap step ran them)
    v = want[0]
    plain = ref.bank_sums(v[None], tables)
    columns = torch.cat([spec.leg_proc, spec.leg_link], dim=-1).contiguous()
    this = lambda: grid_tick.grid_tick_sums_cuda(v, tables)
    row = dict(kernel="campaign sums", shape=[cs.CAMPAIGN_B, T, P, L], other="v @ columns",
               this_bitwise=held("this sums", this(), [x[0] for x in plain], ("proc", "link"),
                                 exact=True) == 0.0)
    row.update(turns(lambda: v @ columns, this, 200, "bank_sums_kernel", other_tag=""))
    print(json.dumps(row), flush=True)


def other_selu(lib, x, ws, bs):
    n, f_in = x.shape
    depth = len(ws) - 1
    wp = (P * (depth + 1))(*[w.data_ptr() for w in ws])
    bp = (P * (depth + 1))(*[b.data_ptr() for b in bs])
    out = torch.empty(n, ws[-1].shape[1], device=x.device)
    err = lib.selu_mlp_launch(x.data_ptr(), wp, bp, out.data_ptr(), None, n, f_in,
                              ws[0].shape[1], depth, ws[-1].shape[1],
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"other selu_mlp launch failed: {err}")
    return out


def other_mlstm(lib, q, k, v, ig, fg, chunk, normalize):
    """The other build's cell as ``mlstm_chunk_cuda`` launches it, with the
    other's C signature."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    code = flash_attention.dtype_code(q)
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    tail = (B, S, H, Dk, Dv, chunk, int(normalize), Dk ** -0.5 if normalize else 1.0, 1e-6,
            30.0 if normalize else 0.0, code, torch.cuda.current_stream().cuda_stream)
    ptrs = [x.data_ptr() for x in (q, k, v, ig, fg, out)]
    if lib.scratch:
        n = lib.mlstm_chunk_scratch_floats(B, S, H, Dk, Dv, chunk, code)
        scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        ptrs.append(None if scratch is None else scratch.data_ptr())
    err = lib.mlstm_chunk_launch(*ptrs, *tail)
    if err != 0:
        raise RuntimeError(f"other mlstm_chunk launch failed: {err}")
    return out


def other_flash(lib, q, k, v, **kw):
    """``(out, lse)`` of the other build's forward through this checkout's
    launch arguments."""
    B, Sq, Hq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    kw = dict(dict(causal=True, window=None, scale=None, q_offset=0), **kw)
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *flash_attention._launch_args(B, Sq, k.shape[1], Hq, k.shape[2], D, kw["causal"],
                                      kw["window"], kw["q_offset"], kw["scale"],
                                      flash_attention.dtype_code(q), q))
    if err != 0:
        raise RuntimeError(f"other flash_attention launch failed: {err}")
    return out, lse


def other_flash_bwd(lib, q, k, v, out, lse, dout, **kw):
    """``(dq, delta, dk, dv)`` of the other build's two backward kernels
    through this checkout's launch arguments."""
    B, Sq, Hq, D = q.shape
    kw = dict(dict(causal=True, window=None, scale=None, q_offset=0), **kw)
    args = flash_attention._launch_args(B, Sq, k.shape[1], Hq, k.shape[2], D, kw["causal"],
                                        kw["window"], kw["q_offset"], kw["scale"],
                                        flash_attention.dtype_code(q), q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ptr = lambda *xs: [x.data_ptr() for x in xs]
    for fn, ptrs in (("flash_attention_bwd_dq_launch", ptr(q, k, v, out, dout, lse, delta, dq)),
                     ("flash_attention_bwd_dkv_launch", ptr(q, k, v, dout, lse, delta, dk, dv))):
        err = getattr(lib, fn)(*ptrs, *args)
        if err != 0:
            raise RuntimeError(f"other {fn} failed: {err}")
    return dq, delta, dk, dv


def this_flash_bwd(q, k, v, out, lse, dout, **kw):
    """``(dq, delta, dk, dv)`` of this build's two backward kernels."""
    dq, delta = flash_attention.flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, **kw)
    return (dq, delta, *flash_attention.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout, **kw))


def ab_flash(other_lib, dev) -> None:
    """The forward and the backward at D <= 64: this build bitwise the
    other's."""
    cases = [(label, shape, kw, dtype, False)
             for dtype in (torch.float32, torch.bfloat16)
             for label, shape, kw in cs.FLASH_CASES]
    cases += [("unaligned", (2, 100, 100, 6, 2, 64), {}, dtype, True)
              for dtype in (torch.float32, torch.bfloat16)]
    cfg = cs.configs.get_config(cs.HYMBA)
    main = (cs.LLM_B, cs.LLM_S, cs.LLM_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    cases += [(f"main {w}", main, dict(window=w), torch.bfloat16, False) for w in (None, cfg.window)]
    tiny = cs.configs.get_config(cs.TINYLLAMA)
    cases.append(("train", (cs.TRAIN_B, cs.TRAIN_S, cs.TRAIN_S, tiny.n_heads, tiny.n_kv_heads,
                            tiny.hd), {}, torch.bfloat16, False))
    for label, shape, kw, dtype, shift in cases:
        q, k, v = cs.flash_case(*shape, dtype, seed=shape[1], dev=dev)
        dout = cs.flash_case(shape[0], shape[1], 1, shape[3], 1, shape[5], dtype,
                             seed=shape[1] + 1, dev=dev)[0]
        if shift:
            q, k, v, dout = (cs.unaligned(x) for x in (q, k, v, dout))
        this = flash_attention.flash_attention_cuda(q, k, v, **kw)
        other = other_flash(other_lib, q, k, v, **kw)
        same = all(torch.equal(a, b) for a, b in zip(this, other))
        this_bwd = this_flash_bwd(q, k, v, *this, dout, **kw)
        other_bwd = other_flash_bwd(other_lib, q, k, v, *this, dout, **kw)
        same_bwd = [bool(torch.equal(a, b)) for a, b in zip(this_bwd, other_bwd)]
        err = cs.check_flash(label, q, k, v, dtype, phase="ab_flash", **kw)
        row = dict(kernel="flash_attention_fwd", case=label, dtype=str(dtype), shape=list(shape),
                   bitwise_other=same, bitwise_other_dq_delta_dk_dv=same_bwd, max_rel_err=err,
                   **kw)
        if label.startswith("main"):
            row.update(turns(lambda: other_flash(other_lib, q, k, v, **kw),
                             lambda: flash_attention.flash_attention_cuda(q, k, v, **kw), 20,
                             "flash_fwd"))
        if label == "train":
            for part in ("dq", "dkv"):
                row[part] = turns(lambda: other_flash_bwd(other_lib, q, k, v, *this, dout, **kw),
                                  lambda: this_flash_bwd(q, k, v, *this, dout, **kw), 10,
                                  f"flash_bwd_{part}")
        print(json.dumps(row), flush=True)
        if not (same and all(same_bwd)):
            raise AssertionError(f"flash {label} {dtype}: this build's bits differ from the other's")


def ab_mlstm(other_lib, dev) -> None:
    """The SSD kernel at hymba's serving shape; xlstm-350m's prefill shape in
    bf16 (this build's pair against the other's kernel) and float32 (the
    Dk-tiled kernel, bitwise), and float32 bitwise on the tiled cases."""
    bf, f32 = torch.bfloat16, torch.float32
    ssd = cs.mlstm_case(cs.LLM_B, cs.LLM_S, 25, 16, 128, False, bf, seed=13, dev=dev)
    want = ref.mlstm_chunk_chunked(*ssd, chunk=128, normalize=False)
    this = lambda: mlstm_chunk.mlstm_chunk_cuda(*ssd, chunk=128, normalize=False)
    other = lambda: other_mlstm(other_lib, *ssd, 128, False)
    row = dict(kernel="mlstm_chunk", shape=[cs.LLM_B, cs.LLM_S, 25, 16, 128], chunk=128,
               this_rel_err=cs.rel_err("this ssd", this(), want, cs.LLM_TOL[bf]),
               other_rel_err=cs.rel_err("other ssd", other(), want, cs.LLM_TOL[bf]))
    row.update(turns(other, this, 20, "mlstm"))
    print(json.dumps(row), flush=True)
    del ssd

    cfg = cs.configs.get_config(cs.XLSTM)
    H = cfg.n_heads
    D = cfg.ssm_expand * cfg.d_model // H
    shape = [cs.LLM_B, cs.LLM_S, H, D, D]
    x = cs.mlstm_case(*shape[:3], D, D, True, bf, seed=17, dev=dev)
    want = ref.mlstm_chunk_chunked(*x, chunk=128, normalize=True)
    this = lambda: mlstm_chunk.mlstm_chunk_cuda(*x, chunk=128, normalize=True)
    other = lambda: other_mlstm(other_lib, *x, 128, True)
    row = dict(kernel="mlstm past Dk 64, bf16", shape=shape, chunk=128,
               this_kernels="mlstm_wide_state_kernel, mlstm_wide_out_kernel",
               this_rel_err=cs.rel_err("this xlstm", this(), want, cs.LLM_TOL[bf]),
               other_rel_err=cs.rel_err("other xlstm", other(), want, cs.LLM_TOL[bf]))
    row.update(turns(other, this, 5, "mlstm_wide", other_tag="mlstm_"))
    print(json.dumps(row), flush=True)
    del x, want

    same = []
    cases = [(2, S_, H_, Dk, Dv, normalize) for normalize, S_, H_, Dk, Dv in cs.TILED_CASES]
    for B, S_, H_, Dk, Dv, normalize in cases + [(*shape[:3], D, D, True)]:
        x = cs.mlstm_case(B, S_, H_, Dk, Dv, normalize, f32, seed=S_ + Dk, dev=dev)
        this = mlstm_chunk.mlstm_chunk_cuda(*x, chunk=128, normalize=normalize)
        same.append(bool(torch.equal(this, other_mlstm(other_lib, *x, 128, normalize))))
        print(json.dumps(dict(kernel="mlstm_chunk_tiled", dtype="float32", shape=[B, S_, H_, Dk, Dv],
                              normalize=normalize, bitwise_other=same[-1])), flush=True)
    row = dict(kernel="mlstm_chunk_tiled", dtype="float32", shape=shape, chunk=128)
    row.update(turns(lambda: other_mlstm(other_lib, *x, 128, True),
                     lambda: mlstm_chunk.mlstm_chunk_cuda(*x, chunk=128, normalize=True), 3,
                     "mlstm_chunk_tiled"))
    print(json.dumps(row), flush=True)
    if not all(same):
        raise AssertionError("mlstm float32: this build's bits differ from the other's")


def event_turns(other, this, reps) -> dict:
    """CUDA-event ms of each (``chip_smoke.timed``), in turns other, this,
    this, other."""
    o1, t1, t2, o2 = (cs.timed(fn, reps)[0] for fn in (other, this, this, other))
    return dict(other_ms=[o1, o2], this_ms=[t1, t2])


def turns(other, this, reps, tag, other_tag=None) -> dict:
    """Device ms of each, in turns other, this, this, other (the other's
    kernels named ``other_tag`` where their names differ; "" takes all)."""
    other_tag = tag if other_tag is None else other_tag
    o1 = cs.device_ms(other, reps, other_tag)
    t1 = cs.device_ms(this, reps, tag)
    t2 = cs.device_ms(this, reps, tag)
    o2 = cs.device_ms(other, reps, other_tag)
    return dict(other_ms=[o1, o2], this_ms=[t1, t2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout's kernels/csrc directory")
    ap.add_argument("--groups", nargs="+", default=["bank", "campaign", "selu_mlp", "mlstm_chunk"],
                    choices=["bank", "campaign", "selu_mlp", "mlstm_chunk", "flash"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sorted({{"bank": "grid_tick", "campaign": "grid_tick",
                     "flash": "flash_attention"}.get(g, g) for g in args.groups})
    _build.build(names)
    out_dir = os.path.join(ROOT, "build", "ab_other")
    libs = build_other(args.other, out_dir, names)
    if "bank" in args.groups:
        ab_bank(libs["grid_tick"], dev)
    if "campaign" in args.groups:
        ab_campaign(libs["grid_tick"], dev)
    if "flash" in args.groups:
        ab_flash(libs["flash_attention"], dev)
    if "selu_mlp" in args.groups:
        for n in (4, 37, 4096, 8192):
            x, ws, bs = cs.mlp_net(n, cs.MLP_IN, dev, seed=n)
            want = ref.selu_mlp(x, ws, bs)
            this_out, _ = selu_mlp.selu_mlp_cuda(x, ws, bs)
            row = dict(kernel="selu_mlp", N=n, this_bitwise=bool(torch.equal(this_out, want)),
                       other_bitwise=bool(torch.equal(other_selu(libs["selu_mlp"], x, ws, bs), want)),
                       tile=list(selu_mlp.tile(n, cs.MLP_IN, cs.MLP_HIDDEN)))
            row.update(turns(lambda: other_selu(libs["selu_mlp"], x, ws, bs),
                             lambda: selu_mlp.selu_mlp_cuda(x, ws, bs), 200, "selu_mlp_kernel"))
            print(json.dumps(row), flush=True)
    if "mlstm_chunk" in args.groups:
        ab_mlstm(libs["mlstm_chunk"], dev)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
