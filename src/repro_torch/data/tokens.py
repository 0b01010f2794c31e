"""Deterministic synthetic LM token pipeline.

Produces a resumable stream of next-token-predictable batches: sequences are
generated by a mixture of (a) an order-2 markov chain over a small state
space and (b) periodic copy patterns, so a trained model's loss decreases —
enough signal for the end-to-end examples without external data.

Determinism contract: batch ``i`` depends only on ``(seed, i)``, so elastic
restarts resume the exact data order from the step counter alone.

A copy of the reference package's ``repro.data.tokens`` (numpy only): the
same ``(cfg, index)`` gives the same int32 tokens byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenStreamConfig", "TokenStream", "make_batch"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov structure
    n_states: int = 64
    copy_period: int = 17


def make_batch(cfg: TokenStreamConfig, index: int) -> Dict[str, np.ndarray]:
    """Batch ``index`` of the stream (pure function of (cfg, index))."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + index) % (2**31 - 1))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    n = min(cfg.n_states, V)
    # fixed markov transition per stream (seeded by cfg.seed only)
    trng = np.random.RandomState(cfg.seed)
    trans = trng.dirichlet(np.ones(n) * 0.3, size=n)  # [n, n]
    cum = np.cumsum(trans, axis=1)

    state = rng.randint(0, n, size=B)
    toks = np.empty((B, S), np.int64)
    u = rng.rand(B, S)
    for t in range(S):
        state = (cum[state] > u[:, t : t + 1]).argmax(axis=1)
        toks[:, t] = state
    # overlay periodic copy pattern on a slice of positions
    phase = rng.randint(0, cfg.copy_period, size=(B, 1))
    pos = np.arange(S)[None, :]
    copy_mask = (pos + phase) % cfg.copy_period == 0
    toks = np.where(copy_mask, (pos // cfg.copy_period) % n, toks)
    toks = toks % V
    return {"tokens": toks.astype(np.int32)}


class TokenStream:
    """Stateful iterator facade with O(1) resume via ``seek``."""

    def __init__(self, cfg: TokenStreamConfig, start_index: int = 0) -> None:
        self.cfg = cfg
        self.index = start_index

    def seek(self, index: int) -> None:
        self.index = index

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.index)
        self.index += 1
        return batch
