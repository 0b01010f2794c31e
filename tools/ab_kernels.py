"""Time kernels of this checkout beside the same kernels built from another
checkout's sources, in one process on one card, and check that both agree
with the plain versions.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    mkdir -p build/other && git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/other
    python3 tools/ab_kernels.py --other build/other/src/repro_torch/kernels/csrc

Groups (``--groups``, default all):

- ``bank``: the banked simulator's fused window (``bank_fused_kernel``, one
  K = 32 window of the stochastic tick run's first carry) and one tick
  (``bank_tick_kernel``, ``remaining = inf`` as the leap scan calls it) at
  the main path's shapes (1,024 scenarios x 64 replicas). Both builds run
  through this checkout's wrappers (the other's library swapped in), so the
  other sources must export the same C signatures (commit 593f029 does);
  both bitwise against the plain versions.
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
- ``selu_mlp``, ``mlstm_chunk``: called with this checkout's C signatures,
  so the other sources must export the same two (commit 386eef2 does).

Each kernel is timed as device time under ``torch.profiler``
(``chip_smoke.device_ms``) in turns: other, this, this, other. One JSON line
per shape, then the card's name and power limit.
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
from repro_torch.kernels import _build, grid_tick, mlstm_chunk, ref, selu_mlp  # noqa: E402

P = ctypes.c_void_p
I = ctypes.c_int
# the per-campaign launch's C signature at commit 593f029
OLD_CAMPAIGN_ARGTYPES = [P] * 3 + [I] + [P] * 3 + [I] + [P] * 3 + [I] * 4 + [P]


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
    for name, mod in (("selu_mlp", selu_mlp), ("mlstm_chunk", mlstm_chunk)):
        if name in libs:
            getattr(libs[name], f"{name}_launch").argtypes = getattr(mod._lib(), f"{name}_launch").argtypes
    if "grid_tick" in libs:
        ours, other = grid_tick._lib(), libs["grid_tick"]
        for fn in ("grid_tick_bank_fused_launch", "grid_tick_bank_launch", "grid_tick_limits"):
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


def ab_bank(other_lib, dev) -> None:
    """B.1's full window and B.2's tick at the main path's shapes."""
    bank = build_bank(n=cs.N_SCEN, seed=0)
    S, R, K = cs.N_SCEN, cs.N_REP, 32
    T, L = bank.pad_legs, bank.pad_links
    spec = engine.bank_spec(bank, dev)
    p = engine.make_bank_params(bank, bg_mu=2.0, bg_sigma=1.0, device=dev)
    mu, sigma = p.bg_mu[:, None].contiguous(), p.bg_sigma[:, None].contiguous()
    consts = (spec.release, spec.dep, spec.bg_period, spec.max_ticks, p.keep_frac,
              spec.bandwidth, spec.leg_proc, spec.proc_link, spec.leg_link)
    c = engine._banked_init_carry(spec, p, torch.zeros((S, R, 2), dtype=torch.int64, device=dev))
    state = (c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
             c.t_start, c.t_end, c.conth, c.conpr, c.bg)
    noise = torch.randn((K, S, R, L), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tables = spec.bank_tables
    want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                     tables=tables)
    fields = ref.BANK_WINDOW_STATE_FIELDS
    this = lambda: grid_tick.grid_tick_bank_fused_cuda(state, noise, mu, sigma, *consts[:6], tables)
    other = through(other_lib, this)
    row = dict(kernel="bank_fused_kernel", shape=[K, S, R, T, bank.pad_procs, L],
               alive_steps=int(want[1].sum()),
               this_bitwise=held("this fused", this(), want, fields, exact=True) == 0.0,
               other_bitwise=held("other fused", other(), want, fields, exact=True) == 0.0)
    row.update(turns(other, this, 5, "bank_fused_kernel"))
    print(json.dumps(row), flush=True)

    g = torch.Generator(device="cpu").manual_seed(2)
    active = ((torch.rand((S, R, T), generator=g) < 0.5).to(dev).float()
              * spec.leg_valid[:, None].float())
    remaining = torch.full((S, R, T), float("inf"), device=dev)
    bg = torch.rand((S, R, L), generator=g).to(dev)
    keep = p.keep_frac.contiguous()
    want = ref.grid_tick_bank_indexed(active, remaining, keep, bg, spec.bandwidth,
                                      spec.leg_proc, spec.proc_link, tables)
    names = ("xfer", "proc_xfer", "link_xfer")
    this = lambda: grid_tick.grid_tick_bank_cuda(active, remaining, keep, bg, spec.bandwidth, tables)
    other = through(other_lib, this)
    row = dict(kernel="bank_tick_kernel", shape=[S, R, T, bank.pad_procs, L],
               this_bitwise=held("this tick", this(), want, names, exact=True) == 0.0,
               other_bitwise=held("other tick", other(), want, names, exact=True) == 0.0)
    row.update(turns(other, this, 50, "bank_tick_kernel"))
    print(json.dumps(row), flush=True)


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


def other_ssd(lib, q, k, v, ig, fg, chunk):
    B, S, H, Dk = q.shape
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    err = lib.mlstm_chunk_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                                 fg.data_ptr(), out.data_ptr(), B, S, H, Dk, v.shape[-1], chunk,
                                 0, 1.0, 1e-6, 0.0, 1, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"other mlstm_chunk launch failed: {err}")
    return out


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
                    choices=["bank", "campaign", "selu_mlp", "mlstm_chunk"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sorted({{"bank": "grid_tick", "campaign": "grid_tick"}.get(g, g) for g in args.groups})
    _build.build(names)
    out_dir = os.path.join(ROOT, "build", "ab_other")
    libs = build_other(args.other, out_dir, names)
    if "bank" in args.groups:
        ab_bank(libs["grid_tick"], dev)
    if "campaign" in args.groups:
        ab_campaign(libs["grid_tick"], dev)
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
        bf = torch.bfloat16
        ssd = cs.mlstm_case(cs.LLM_B, cs.LLM_S, 25, 16, 128, False, bf, seed=13, dev=dev)
        want = ref.mlstm_chunk_chunked(*ssd, chunk=128, normalize=False)
        row = dict(kernel="mlstm_chunk", shape=[cs.LLM_B, cs.LLM_S, 25, 16, 128], chunk=128,
                   this_rel_err=cs.rel_err("this ssd", mlstm_chunk.mlstm_chunk_cuda(
                       *ssd, chunk=128, normalize=False), want, cs.LLM_TOL[bf]),
                   other_rel_err=cs.rel_err("other ssd", other_ssd(libs["mlstm_chunk"], *ssd, 128),
                                            want, cs.LLM_TOL[bf]))
        row.update(turns(lambda: other_ssd(libs["mlstm_chunk"], *ssd, 128),
                         lambda: mlstm_chunk.mlstm_chunk_cuda(*ssd, chunk=128, normalize=False), 20,
                         "mlstm"))
        print(json.dumps(row), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
