"""Campaign generators reproducing the paper's Section-3 empirical setups.

- :func:`placement_campaign` — gsiftp SE->SE transfers with varying process
  concurrency (the FZK -> SLAC dataset behind Eq. 3 / Fig. 1).
- :func:`stagein_campaign` — 1-12 concurrent single-process xrdcp stage-ins of
  300MB-3GB files on one worker node (Eq. 4 / Fig. 2).
- :func:`bidirectional_probe` — paired A->B / B->A campaigns used for the
  Fig. 3 uni-directionality analysis.

These generators produce *workloads*; the observations come from simulating
them with :mod:`repro_torch.core.engine` and regressing with
:mod:`repro.core.regression` (not yet ported).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.topology import Grid
from repro_torch.core.workload import (
    AccessProfileKind,
    Campaign,
    FileAccess,
    Job,
    Replica,
)

__all__ = [
    "placement_campaign",
    "stagein_campaign",
    "bidirectional_probe",
    "remote_campaign",
]


def _two_se_grid(
    bandwidth: float, bg_mu: float, bg_sigma: float, bg_update_period: int
) -> Grid:
    g = Grid()
    g.add_data_center("SRC-DC")
    g.add_data_center("DST-DC")
    g.add_storage_element("SRC_DATADISK", "SRC-DC")
    g.add_storage_element("DST_DATADISK", "DST-DC")
    g.add_worker_node("dst-wn00", "DST-DC")
    g.add_link(
        "SRC_DATADISK",
        "DST_DATADISK",
        bandwidth=bandwidth,
        bg_mu=bg_mu,
        bg_sigma=bg_sigma,
        bg_update_period=bg_update_period,
    )
    g.add_link("DST_DATADISK", "dst-wn00", bandwidth=2.0 * bandwidth)
    return g


def placement_campaign(
    *,
    n_waves: int = 40,
    max_concurrent: int = 16,
    min_size_mb: float = 300.0,
    max_size_mb: float = 3000.0,
    wave_period_ticks: int = 600,
    bandwidth: float = 1250.0,
    bg_mu: float = 0.0,
    bg_sigma: float = 0.0,
    bg_update_period: int = 60,
    seed: int = 0,
) -> Tuple[Grid, Campaign]:
    """SE->SE data-placement waves with varying process concurrency.

    Mirrors the FZK-LCG2 -> SLACXRD gsiftp dataset: each wave launches a
    random number of concurrent placement processes (one per file). The
    stage-in half of the placement profile is deliberately excluded (the
    paper's Eq. 3 dataset contains only the SE->SE gsiftp legs), so the
    campaign is built from bare placement legs via a virtual destination SE:
    we model this by placing with an explicit local SE and never staging —
    accomplished with ``AccessProfileKind.STAGE_IN`` on the reverse link being
    absent and filtering observations by profile tag downstream.
    """
    rng = np.random.RandomState(seed)
    g = _two_se_grid(bandwidth, bg_mu, bg_sigma, bg_update_period)
    accesses: List[FileAccess] = []
    for wave in range(n_waves):
        t0 = wave * wave_period_ticks
        n_conc = int(rng.randint(1, max_concurrent + 1))
        for _ in range(n_conc):
            size = float(rng.uniform(min_size_mb, max_size_mb))
            accesses.append(
                FileAccess(
                    replica=Replica(size, "SRC_DATADISK"),
                    profile=AccessProfileKind.DATA_PLACEMENT,
                    protocol="gsiftp",
                    release_tick=t0,
                    local_storage_element="DST_DATADISK",
                )
            )
    job = Job(worker_node="dst-wn00", accesses=tuple(accesses), name="placement")
    return g, Campaign((job,), name="placement-fzk-slac")


def stagein_campaign(
    *,
    n_waves: int = 30,
    max_jobs: int = 12,
    min_size_mb: float = 300.0,
    max_size_mb: float = 3000.0,
    wave_period_ticks: int = 600,
    bandwidth: float = 1250.0,
    bg_mu: float = 0.0,
    bg_sigma: float = 0.0,
    bg_update_period: int = 60,
    seed: int = 1,
) -> Tuple[Grid, Campaign]:
    """1-12 concurrent jobs, each staging-in one file per wave over xrdcp
    from the local SE (the CERN worker-node experiment behind Eq. 4)."""
    rng = np.random.RandomState(seed)
    g = Grid()
    g.add_data_center("CERN")
    g.add_storage_element("CERN-PROD_DATADISK", "CERN")
    g.add_worker_node("cern-wn00", "CERN")
    g.add_link(
        "CERN-PROD_DATADISK",
        "cern-wn00",
        bandwidth=bandwidth,
        bg_mu=bg_mu,
        bg_sigma=bg_sigma,
        bg_update_period=bg_update_period,
    )
    jobs_accs: List[List[FileAccess]] = [[] for _ in range(max_jobs)]
    for wave in range(n_waves):
        t0 = wave * wave_period_ticks
        n_jobs = int(rng.randint(1, max_jobs + 1))
        for j in range(n_jobs):
            size = float(rng.uniform(min_size_mb, max_size_mb))
            jobs_accs[j].append(
                FileAccess(
                    replica=Replica(size, "CERN-PROD_DATADISK"),
                    profile=AccessProfileKind.STAGE_IN,
                    protocol="xrdcp",
                    release_tick=t0,
                )
            )
    jobs = tuple(
        Job(worker_node="cern-wn00", accesses=tuple(a), name=f"job{j}")
        for j, a in enumerate(jobs_accs)
        if a
    )
    return g, Campaign(jobs, name="stagein-cern")


def remote_campaign(
    *,
    n_waves: int = 26,
    max_jobs: int = 12,
    max_threads: int = 4,
    wave_period_ticks: int = 900,
    bandwidth: float = 1250.0,
    seed: int = 2,
    **sizes: float,
) -> Tuple[Grid, Campaign]:
    """Thin alias of the WLCG production workload generator with free seeding
    (used by calibration presimulation)."""
    from repro_torch.core.workload import wlcg_production_workload

    return wlcg_production_workload(
        n_waves=n_waves,
        max_jobs=max_jobs,
        max_threads=max_threads,
        wave_period_ticks=wave_period_ticks,
        link_bandwidth=bandwidth,
        seed=seed,
        **sizes,
    )


def bidirectional_probe(
    *,
    n_waves: int = 24,
    files_per_wave: int = 8,
    wave_period_ticks: int = 3600,
    bw_ab: float = 1250.0,
    bw_ba: float = 400.0,
    bg_ab: Tuple[float, float] = (4.0, 2.0),
    bg_ba: Tuple[float, float] = (30.0, 10.0),
    min_size_mb: float = 300.0,
    max_size_mb: float = 3000.0,
    seed: int = 3,
) -> Tuple[Grid, Campaign, Campaign]:
    """Two asymmetric campaigns A->B and B->A over independently parameterized
    uni-directional links (the RAL <-> SWT2 Fig. 3 analysis): the hourly
    regression coefficients of the two directions must *not* coincide."""
    rng = np.random.RandomState(seed)
    g = Grid()
    g.add_data_center("RAL")
    g.add_data_center("SWT2")
    g.add_storage_element("RAL_ECHO_DATADISK", "RAL")
    g.add_storage_element("SWT2_CPB_DATADISK", "SWT2")
    g.add_worker_node("ral-wn00", "RAL")
    g.add_worker_node("swt2-wn00", "SWT2")
    g.add_link("RAL_ECHO_DATADISK", "SWT2_CPB_DATADISK", bw_ab, *bg_ab)
    g.add_link("SWT2_CPB_DATADISK", "RAL_ECHO_DATADISK", bw_ba, *bg_ba)
    g.add_link("SWT2_CPB_DATADISK", "swt2-wn00", 2 * bw_ab)
    g.add_link("RAL_ECHO_DATADISK", "ral-wn00", 2 * bw_ba)

    def _mk(src_se: str, dst_se: str, wn: str, name: str) -> Campaign:
        accs: List[FileAccess] = []
        for wave in range(n_waves):
            t0 = wave * wave_period_ticks
            for _ in range(int(rng.randint(1, files_per_wave + 1))):
                size = float(rng.uniform(min_size_mb, max_size_mb))
                accs.append(
                    FileAccess(
                        replica=Replica(size, src_se),
                        profile=AccessProfileKind.DATA_PLACEMENT,
                        protocol="gsiftp",
                        release_tick=t0,
                        local_storage_element=dst_se,
                    )
                )
        return Campaign((Job(wn, tuple(accs), name),), name=name)

    camp_ab = _mk("RAL_ECHO_DATADISK", "SWT2_CPB_DATADISK", "swt2-wn00", "ab")
    camp_ba = _mk("SWT2_CPB_DATADISK", "RAL_ECHO_DATADISK", "ral-wn00", "ba")
    return g, camp_ab, camp_ba
