"""Time the SELU-MLP and chunkwise SSD kernels of this checkout beside the
same kernels built from another checkout's sources, in one process on one
card, and check that both agree with the plain versions.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    mkdir -p build/other && git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/other
    python3 tools/ab_kernels.py --other build/other/src/repro_torch/kernels/csrc

The other build's ``selu_mlp_launch`` and ``mlstm_chunk_launch`` are called
with this checkout's C signatures, so the other sources must export the
same two (commit 386eef2 does). Each kernel is timed as device time under
``torch.profiler`` (``chip_smoke.device_ms``) in turns: other, this, this,
other. One JSON line per shape, then the card's name and power limit.
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
from repro_torch.kernels import _build, mlstm_chunk, ref, selu_mlp  # noqa: E402

P = ctypes.c_void_p


def build_other(csrc: str, out_dir: str) -> dict:
    """Build the other checkout's two sources with this checkout's flags."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"),
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("selu_mlp", "mlstm_chunk")
    }
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"other {name}.cu did not build:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    for name, mod in (("selu_mlp", selu_mlp), ("mlstm_chunk", mlstm_chunk)):
        getattr(libs[name], f"{name}_launch").argtypes = getattr(mod._lib(), f"{name}_launch").argtypes
    return libs


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


def turns(other, this, reps, tag) -> dict:
    """Device ms of each, in turns other, this, this, other."""
    o1 = cs.device_ms(other, reps, tag)
    t1 = cs.device_ms(this, reps, tag)
    t2 = cs.device_ms(this, reps, tag)
    o2 = cs.device_ms(other, reps, tag)
    return dict(other_ms=[o1, o2], this_ms=[t1, t2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout's kernels/csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build(["selu_mlp", "mlstm_chunk"])
    libs = build_other(args.other, os.path.join(ROOT, "build", "ab_other"))
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
