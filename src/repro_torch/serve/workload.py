"""Seeded open-loop synthetic request workload.

Open-loop in the queueing sense: arrival times are drawn up front from a
Poisson process (exponential inter-arrivals at ``rate`` requests a second)
independent of service progress, so the server's latency under load, not
its pacing of the client, is what a benchmark measures. Campaigns come from
the scenario-family registry (:func:`repro_torch.core.scenarios.sample_scenarios`),
round-robined for heterogeneity, with optional per-request stochastic
replicas.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scenarios import sample_scenarios
from repro_torch.serve.request import SimRequest

__all__ = ["synthetic_workload"]


def synthetic_workload(
    n_requests: int,
    *,
    rate: float = 50.0,
    families: Optional[Sequence[str]] = None,
    seed: int = 0,
    scale: float = 1.0,
    replicas: int = 1,
    theta=None,
) -> List[Tuple[float, SimRequest]]:
    """``[(arrival_time, request), ...]`` sorted by arrival time.

    ``arrival_time`` is seconds since the workload's epoch (the first
    arrival at 0); ``rate`` is the open-loop arrival intensity. Each request
    carries its own RNG seed derived from ``seed``: replaying a workload is
    deterministic end to end.
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1: {n_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0: {rate}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    pairs = sample_scenarios(families, n=n_requests, seed=seed, scale=scale)
    out: List[Tuple[float, SimRequest]] = []
    for i, ((grid, campaign), t) in enumerate(zip(pairs, arrivals)):
        out.append(
            (
                float(t),
                SimRequest(
                    rid=i,
                    grid=grid,
                    campaign=campaign,
                    theta=theta,
                    n_replicas=replicas,
                    seed=seed + 1000 + i,
                    name=f"wl_{i}",
                ),
            )
        )
    return out
