"""Decode against prefill in bf16 for hymba-1.5b at full width, over
several seeds and with the prefill's SSD cell taken three ways.

The check ``decode vs prefill (bf16)`` of ``chip_smoke.py`` compares, on one
seed, the logits of position 2,048 from a prefill over 2,049 tokens with
those of a prefill over 2,048 tokens and one decode step. This script
repeats it for ``--seeds`` (seed s makes the weights and the tokens as the
smoke makes them for seed 0) and, for each seed, with the bf16 SSD cell of
the prefill (``ops.mlstm_chunk`` with ``normalize=False``) taken as

- ``kernel``: the tensor-core kernel, as the main path runs it;
- ``rounding_model``: ``ref.mlstm_chunk_tc`` on the card, the kernel's
  rounding points in plain PyTorch;
- ``float32_plain``: ``ref.mlstm_chunk_chunked``, the float32 recurrence
  rounded once at its output (what a float32 CUDA-core cell gives).

Each line holds the bf16 prefill's and the bf16 decode step's largest
distance from the float32 prefill, and the decode step's from the bf16
prefill, each over the largest entry of the logits it is compared with (as
``chip_smoke.py`` divides), and the SSD launches of that run's prefills
(nonzero only for ``kernel``). Run on a machine with an NVIDIA GPU from the
root of a checkout:

    python3 tools/serve_drift.py --seeds 0 1 2

One JSON line per (seed, cell), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import mlstm_chunk, ops, ref  # noqa: E402
from repro_torch.models import model as llm  # noqa: E402

KERNEL_CELL = ops.mlstm_chunk


def dist(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|``."""
    return float((got.double() - want.double()).abs().max()) / float(want.double().abs().max())


def ssd_cell(plain):
    """``ops.mlstm_chunk`` with its bf16 SSD calls sent to ``plain``."""
    def cell(q, k, v, i_gate, f_gate, *, chunk=128, eps=1e-6, normalize=True, scale=None):
        if normalize or q.dtype != torch.bfloat16:
            return KERNEL_CELL(q, k, v, i_gate, f_gate, chunk=chunk, eps=eps,
                               normalize=normalize, scale=scale)
        return plain(q, k, v, i_gate, f_gate, chunk=chunk, scale=scale)
    return cell


CELLS = {
    "kernel": KERNEL_CELL,
    "rounding_model": ssd_cell(ref.mlstm_chunk_tc),
    "float32_plain": ssd_cell(lambda *a, chunk, scale: ref.mlstm_chunk_chunked(
        *a, chunk=chunk, normalize=False, scale=scale)),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_drift: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = configs.get_config(cs.HYMBA)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    S = cs.LLM_S
    for seed in args.seeds:
        net = llm.init_params(seed, cfg, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (cs.LLM_B, S + 1),
                               generator=torch.Generator().manual_seed(seed))[:2].to(dev)
        net32 = copy.deepcopy(net).float()
        full32, step32 = cs.decode_vs_prefill(cfg32, net32, tokens, S, dev)
        del net32
        for name, cell in CELLS.items():
            ops.mlstm_chunk = cell
            mlstm_chunk.reset_launches()
            try:
                full16, step16 = cs.decode_vs_prefill(cfg, net, tokens, S, dev)
            finally:
                ops.mlstm_chunk = KERNEL_CELL
            torch.cuda.synchronize()
            print(json.dumps(dict(
                seed=seed, ssd_cell=name, tokens=S + 1, batch=2,
                float32_decode_vs_prefill=dist(step32, full32),
                bf16_prefill_vs_float32=dist(full16, full32),
                bf16_decode_vs_float32=dist(step16, full32),
                bf16_decode_vs_bf16_prefill=dist(step16, full16),
                bf16_tol=cs.SERVE_BF16_TOL,
                argmax_agreement_bf16=float((step16.argmax(-1) == full16.argmax(-1)).float().mean()),
                ssd_launches=mlstm_chunk.LAUNCHES["mlstm_chunk"])), flush=True)
        del net
        torch.cuda.empty_cache()
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
