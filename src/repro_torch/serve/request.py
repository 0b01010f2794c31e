"""Request and response records of the simulation service.

A :class:`SimRequest` is one ``(grid, campaign, theta, n_replicas)`` query:
"this campaign arrives at this grid; how do its transfers go?". The server
compiles it to a single-scenario row at submit time, routes it to the slot
bank of its pad signature, and answers with a :class:`RequestResult` whose
rows are bitwise those of the port's ``Fleet.run`` of the same scenario
with the same keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.engine import SimResult
from repro_torch.core.topology import Grid
from repro_torch.core.workload import Campaign

__all__ = ["SimRequest", "RequestResult"]


@dataclasses.dataclass
class SimRequest:
    """One simulation query.

    ``theta`` is the optional ``[3]`` calibration vector (overhead, bg_mu,
    bg_sigma), applied through the same row-local
    ``calibration.make_theta_mapper`` as ``Fleet.run(theta)``; ``None`` runs
    the campaign's compiled base parameters. Replica RNG: either explicit
    ``keys`` of shape ``[n_replicas, 2]`` (uint32 words, exactly the
    per-scenario rows ``Fleet.run(keys=...)`` would take), or a ``seed``
    from which the server splits ``prng.PRNGKey(seed)`` into ``n_replicas``
    subkeys, the schedule of ``Fleet.run(key=prng.PRNGKey(seed),
    replicas=n_replicas)`` on a single-scenario fleet.
    """

    rid: int
    grid: Grid
    campaign: Campaign
    theta: Optional[np.ndarray] = None
    n_replicas: int = 1
    seed: int = 0
    keys: Optional[np.ndarray] = None  # [n_replicas, 2] uint32
    protocol: str = "webdav"
    name: Optional[str] = None

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {self.n_replicas}")
        if self.keys is not None:
            k = np.asarray(self.keys)
            if k.shape != (self.n_replicas, 2):
                raise ValueError(
                    f"explicit keys must be [n_replicas={self.n_replicas}, 2], "
                    f"got {k.shape}"
                )


@dataclasses.dataclass
class RequestResult:
    """A served answer: the request's :class:`SimResult` rows plus timing.

    ``result`` fields are CPU tensors holding the request's replicas only:
    per-leg fields ``[n_replicas, T]`` at the request's own leg pad,
    ``ticks`` ``[n_replicas]``, cut bitwise out of the slot bank's row.
    The timestamps are ``time.perf_counter`` values of the serving process
    (``latency`` = finish - submit); ``windows`` counts the slot bank's
    window steps the request was resident for, and ``slot`` / ``signature``
    record where it ran.
    """

    rid: int
    name: str
    result: SimResult
    n_replicas: int
    signature: tuple
    slot: int
    submitted_at: float
    admitted_at: float
    finished_at: float
    windows: int

    @property
    def latency(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def queue_delay(self) -> float:
        return self.admitted_at - self.submitted_at
