"""The split-S decode kernel's algorithm, emulated in plain torch on the CPU.

``csrc/decode_attention.cu`` splits each sequence's cache into contiguous
ranges of positions (a multiple of the block's step), computes a float32
partial ``(m, l, acc)`` per range and query head in the log2 domain (q
scaled by ``scale log2 e``), writes an empty partial (``l = 0``) for a
range wholly past ``lengths[b]``, and merges the partials in split order:
``M`` the largest ``m`` of the non-empty ones, ``out = sum acc 2^(m - M) /
sum l 2^(m - M)``, 0 where no position is valid. The emulation below does
the same (the kernel's sums within a range run in another order, which the
float32 limit covers) and must match the port's plain
``ref.decode_attention`` and the reference's
``repro.kernels.ref.decode_attention`` within 2e-5 of max|plain| in
float32: the two sides' softmax sums round in other orders. Inputs from a
numpy seed. Merges with a planted fault (a dropped split; partials merged
without rescaling to the common max) fail the same limit.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

TOL_F32 = 2e-5
LOG2E = 1.4426950408889634
# the kernel's block: 4 warps, 4 rows a lane loads a step, 16 B a lane
WARPS, UNROLL, LANE_BYTES = 4, 4, 16
# a 2,112-slot cache (hymba's serving cache) with ragged lengths: empty,
# one position, one short of and at the 64-position step, and full
S = 2112
LENGTHS = [0, 1, 63, 64, S]


def block_step(D: int, itemsize: int) -> int:
    """Positions a block takes a step (``decode_attention.cu``: 8, 16 or 32
    lanes a row, 32 / lanes rows a warp reads a load)."""
    need = -(-D // (LANE_BYTES // itemsize))
    lanes = next(n for n in (8, 16, 32) if need <= n)
    return WARPS * (32 // lanes) * UNROLL


def split_ranges(s: int, splits: int, step: int):
    """The kernel's ranges for ``splits`` wanted: each a multiple of
    ``step`` positions, the last cut at ``s``."""
    chunk = -(-(-(-s // splits)) // step) * step
    return [(p, min(p + chunk, s)) for p in range(0, s, chunk)]


def emulate_split(q, k, v, lengths, *, splits, fault=None):
    """The kernel's split and merge in float32: ``(out [B, Hq, D], number of
    splits)``. ``fault``: ``"drop"`` leaves the last non-empty split out of
    the merge, ``"max"`` merges the partials without rescaling them to the
    common max."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    ranges = split_ranges(k.shape[1], splits, block_step(D, 4))
    scale2 = torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    qs = (q.float() * scale2).reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        n = max(0, min(int(lengths[b]), k.shape[1]))
        for hk in range(Hkv):
            parts = []
            for p0, p1 in ranges:
                p1 = min(p1, n)
                if p0 >= p1:  # an empty partial
                    parts.append((torch.full((G,), -1e30), torch.zeros(G), None))
                    continue
                s = qs[b, hk] @ k[b, p0:p1, hk].float().T  # [G, positions]
                m = s.amax(-1)
                e = torch.exp2(s - m[:, None])
                parts.append((m, e.sum(-1), e @ v[b, p0:p1, hk].float()))
            if fault == "drop":
                live = [i for i, (_, l, _) in enumerate(parts) if bool((l > 0).any())]
                if live:
                    parts.pop(live[-1])
            big = torch.stack([torch.where(l > 0, m, -1e30) for m, l, _ in parts]).amax(0)
            lt, at = torch.zeros(G), torch.zeros(G, D)
            for m, l, acc in parts:  # split order
                if acc is None:
                    continue
                c = torch.ones(G) if fault == "max" else torch.exp2(m - big)
                c = torch.where(l > 0, c, 0.0)
                lt = lt + l * c
                at = at + acc * c[:, None]
            out[b, hk] = torch.where(lt[:, None] > 0, at / lt.clamp_min(1e-30)[:, None], 0.0)
    return out.reshape(B, Hq, D), len(ranges)


def _inputs(G, D, seed):
    Hkv = 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(LENGTHS), G * Hkv, D)).astype(np.float32)
    k, v = (rng.standard_normal((len(LENGTHS), S, Hkv, D)).astype(np.float32) for _ in range(2))
    return q, k, v, np.asarray(LENGTHS, np.int32)


def _rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("D", [20, 64])
@pytest.mark.parametrize("G", [5, 8])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_merge_matches_references(splits, G, D):
    q, k, v, lengths = _inputs(G, D, seed=100 * splits + 10 * G + D)
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got, n = emulate_split(*args, splits=splits)
    assert n == splits
    # splits wholly past lengths[b] (every split but the first at 1, 63, 64)
    assert splits == 1 or split_ranges(S, splits, block_step(D, 4))[1][0] > 64
    plain = ref.decode_attention(*args)
    assert _rel(got, plain) <= TOL_F32
    assert _rel(got, np.asarray(jref.decode_attention(q, k, v, lengths))) <= TOL_F32
    assert not bool(got[0].abs().max())  # no valid position: exactly 0


@pytest.mark.parametrize("fault", ["drop", "max"])
@pytest.mark.parametrize("splits", [3, 7])
def test_split_merge_rejects_planted_faults(splits, fault):
    q, k, v, lengths = _inputs(5, 64, seed=splits)
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got, _ = emulate_split(*args, splits=splits, fault=fault)
    assert _rel(got, ref.decode_attention(*args)) > TOL_F32, fault


def test_split_ranges_cover_the_cache_in_steps():
    for s, splits, step in ((2112, 7, 64), (2112, 3, 32), (300, 11, 32), (1024, 7, 64), (5, 4, 128)):
        ranges = split_ranges(s, splits, step)
        assert ranges[0][0] == 0 and ranges[-1][1] == s
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        assert all((p1 - p0) % step == 0 for p0, p1 in ranges[:-1])
        assert len(ranges) <= splits and len(ranges) == math.ceil(s / (ranges[0][1] - ranges[0][0]))
