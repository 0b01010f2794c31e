"""Plain-Python reference implementation of the GDAPS tick semantics.

This is the readable, loop-based oracle used to validate the vectorized
engine (:mod:`repro_torch.core.engine`). It implements the paper's transfer
mechanism literally:

    chunk  = (link.bandwidth / (link.background_load + link.campaign_load))
             / job.n_threads
    chunk -= chunk * protocol.overhead

with uni-directional links, per-file processes for placement/stage-in, and
per-(job, link) streaming processes whose active legs are threads.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.workload import LegTable

__all__ = ["reference_simulate"]


def reference_simulate(
    table: LegTable,
    keep_frac: np.ndarray,  # [T]
    bg_mu: np.ndarray,  # [L]
    bg_sigma: np.ndarray,  # [L]
    max_ticks: int,
    bg_sampler: Optional[Callable[[int, np.ndarray], np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Simulate with plain Python loops; returns the same observation fields
    as :class:`repro_torch.core.engine.SimResult`.

    ``bg_sampler(tick, noise_shape)`` lets tests inject the exact same
    background-load samples as the vectorized engine (pass standard-normal
    draws); defaults to numpy's generator.
    """
    n = table.n_legs
    n_links = table.n_links
    rng = np.random.RandomState(1234)

    remaining = table.size_mb.astype(np.float64).copy()
    done = np.zeros(n, bool)
    started = np.zeros(n, bool)
    t_start = np.zeros(n, np.int64)
    t_end = np.zeros(n, np.int64)
    conth = np.zeros(n, np.float64)
    conpr = np.zeros(n, np.float64)
    bg = np.zeros(n_links, np.float64)

    t = 0
    while t < max_ticks and not done.all():
        # background load resample per link update period
        if bg_sampler is not None:
            noise = bg_sampler(t, (n_links,))
        else:
            noise = rng.standard_normal(n_links)
        for l in range(n_links):
            if t % int(table.links.bg_period[l]) == 0:
                bg[l] = max(bg_mu[l] + bg_sigma[l] * noise[l], 0.0)

        # active legs
        active = np.zeros(n, bool)
        for i in range(n):
            if done[i] or table.release[i] > t:
                continue
            d = table.dep[i]
            if d >= 0 and not done[d]:
                continue
            active[i] = True

        # processes: active threads per proc; procs per link
        threads: Dict[int, int] = {}
        for i in range(n):
            if active[i]:
                threads[table.proc_id[i]] = threads.get(int(table.proc_id[i]), 0) + 1
        procs_on_link = np.zeros(n_links, np.float64)
        proc_link: Dict[int, int] = {}
        for i in range(n):
            proc_link[int(table.proc_id[i])] = int(table.link_id[i])
        for p, cnt in threads.items():
            if cnt > 0:
                procs_on_link[proc_link[p]] += 1.0

        # fair-share chunk per leg (paper's snippet)
        xfer = np.zeros(n, np.float64)
        for i in range(n):
            if not active[i]:
                continue
            l = int(table.link_id[i])
            denom = max(procs_on_link[l] + max(bg[l], 0.0), 1.0)
            chunk = (table.links.bandwidth[l] / denom) / threads[int(table.proc_id[i])]
            chunk -= chunk * (1.0 - keep_frac[i])
            xfer[i] = min(remaining[i], chunk)

        # accumulate concurrency traffic during each active leg's window
        proc_xfer: Dict[int, float] = {}
        link_xfer = np.zeros(n_links, np.float64)
        for i in range(n):
            p = int(table.proc_id[i])
            proc_xfer[p] = proc_xfer.get(p, 0.0) + xfer[i]
            link_xfer[int(table.link_id[i])] += xfer[i]
        for i in range(n):
            if not active[i]:
                continue
            p = int(table.proc_id[i])
            l = int(table.link_id[i])
            conth[i] += proc_xfer[p] - xfer[i]
            conpr[i] += link_xfer[l] - proc_xfer[p]

        # state updates
        for i in range(n):
            if not active[i]:
                continue
            if not started[i]:
                started[i] = True
                t_start[i] = t
            remaining[i] -= xfer[i]
            if remaining[i] <= 1e-6:
                done[i] = True
                t_end[i] = t + 1
        t += 1

    return {
        # same masking contract as the vectorized engine: legs that never
        # finish report 0, not the meaningless t_end(=0) - t_start
        "transfer_time": np.where(done, t_end - t_start, 0).astype(np.float64),
        "size_mb": table.size_mb.astype(np.float64),
        "conth_mb": conth,
        "conpr_mb": conpr,
        "done": done,
        "ticks": np.int64(t),
        "profile": table.profile.copy(),
        "start_tick": t_start.astype(np.float64),
    }
