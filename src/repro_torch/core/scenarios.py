"""Scenario families: generator-backed (Grid, Campaign) distributions.

The calibration, validation, and optimizer layers all consume *fleets* of
heterogeneous scenarios, not one campaign. This module is the registry that
turns a family name plus a seed into a concrete ``(Grid, Campaign)`` pair,
and the convenience builders that compile whole fleets into a
:class:`~repro_torch.core.workload.ScenarioBank`.

Families (all knobs are drawn per seed, so two seeds of one family differ in
topology scale, arrival pattern, file sizes, and link parameters):

- ``wlcg-remote``    — the paper's Section-5 remote-access production shape;
- ``stagein``        — concurrent xrdcp stage-ins on one worker node (Eq. 4);
- ``placement``      — SE->SE gsiftp placement waves (Eq. 3);
- ``multi-tier``     — T0 -> T1 -> T2 tiered topology, placements cascading
  toward worker nodes behind the lowest tier;
- ``bursty``         — heavy-tailed burst arrivals (lognormal gaps) of
  remote accesses, the antithesis of the periodic-wave campaigns;
- ``asymmetric-wan`` — two sites pulling placements over independently
  parameterized opposite links (the Fig. 3 uni-directionality setup);
- ``mixed-bag``      — jobs mixing all three access profiles on one grid.

Register new families with :func:`register_family`; ``sample_scenarios``
round-robins families to build diverse fleets.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import (
    placement_campaign,
    remote_campaign,
    stagein_campaign,
)
from repro_torch.core.topology import Grid
from repro_torch.core.workload import (
    AccessProfileKind,
    Campaign,
    FileAccess,
    Job,
    Replica,
    ScenarioBank,
    compile_bank,
)

__all__ = [
    "register_family",
    "family_names",
    "make_scenario",
    "sample_scenarios",
    "build_bank",
]

ScenarioFn = Callable[..., Tuple[Grid, Campaign]]

_FAMILIES: Dict[str, ScenarioFn] = {}


def register_family(name: str) -> Callable[[ScenarioFn], ScenarioFn]:
    """Decorator: register ``fn(seed, scale) -> (Grid, Campaign)``."""

    def deco(fn: ScenarioFn) -> ScenarioFn:
        if name in _FAMILIES:
            raise ValueError(f"duplicate scenario family {name!r}")
        _FAMILIES[name] = fn
        return fn

    return deco


def family_names() -> List[str]:
    return sorted(_FAMILIES)


def make_scenario(family: str, seed: int = 0, *, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    """One concrete scenario of a family. ``scale`` multiplies workload size
    (number of accesses / waves), not file sizes."""
    try:
        fn = _FAMILIES[family]
    except KeyError:
        raise KeyError(
            f"unknown scenario family {family!r}; known: {family_names()}"
        ) from None
    return fn(seed=seed, scale=scale)


def sample_scenarios(
    families: Optional[Sequence[str]] = None,
    n: int = 8,
    seed: int = 0,
    *,
    scale: float = 1.0,
) -> List[Tuple[Grid, Campaign]]:
    """``n`` scenarios round-robined over ``families`` with distinct seeds."""
    families = list(families) if families is not None else family_names()
    return [
        make_scenario(families[i % len(families)], seed=seed + i, scale=scale)
        for i in range(n)
    ]


def build_bank(
    families: Optional[Sequence[str]] = None,
    n: int = 8,
    seed: int = 0,
    *,
    scale: float = 1.0,
    max_ticks=None,
    **compile_kw,
) -> ScenarioBank:
    """Sample a fleet and compile it into one padded bank."""
    return compile_bank(
        sample_scenarios(families, n, seed, scale=scale),
        max_ticks=max_ticks,
        **compile_kw,
    )


# ---------------------------------------------------------------------------
# family definitions
# ---------------------------------------------------------------------------

def _n(rng: np.random.RandomState, lo: int, hi: int, scale: float = 1.0) -> int:
    return max(1, int(round(rng.randint(lo, hi + 1) * scale)))


@register_family("wlcg-remote")
def _wlcg_remote(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    rng = np.random.RandomState(seed)
    return remote_campaign(
        n_waves=_n(rng, 3, 8, scale),
        max_jobs=_n(rng, 2, 6),
        max_threads=_n(rng, 1, 4),
        wave_period_ticks=int(rng.randint(20, 80)),
        bandwidth=float(rng.uniform(100.0, 400.0)),
        seed=seed,
        min_size_mb=20.0,
        max_size_mb=300.0,
    )


@register_family("stagein")
def _stagein(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    rng = np.random.RandomState(seed + 101)
    return stagein_campaign(
        n_waves=_n(rng, 3, 8, scale),
        max_jobs=_n(rng, 2, 8),
        wave_period_ticks=int(rng.randint(20, 80)),
        bandwidth=float(rng.uniform(100.0, 400.0)),
        bg_mu=float(rng.uniform(0.0, 4.0)),
        bg_sigma=0.0,
        seed=seed,
        min_size_mb=20.0,
        max_size_mb=300.0,
    )


@register_family("placement")
def _placement(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    rng = np.random.RandomState(seed + 202)
    return placement_campaign(
        n_waves=_n(rng, 3, 7, scale),
        max_concurrent=_n(rng, 2, 8),
        wave_period_ticks=int(rng.randint(20, 80)),
        bandwidth=float(rng.uniform(100.0, 400.0)),
        bg_mu=float(rng.uniform(0.0, 4.0)),
        bg_sigma=0.0,
        seed=seed,
        min_size_mb=20.0,
        max_size_mb=300.0,
    )


@register_family("multi-tier")
def _multi_tier(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    """T0 -> T1 -> T2 hierarchy: files persist at the T0 archive, jobs run on
    T2 worker nodes; placements cascade one tier at a time while some jobs
    stream straight across the WAN."""
    rng = np.random.RandomState(seed + 303)
    g = Grid()
    g.add_data_center("T0")
    g.add_data_center("T1")
    g.add_data_center("T2")
    g.add_storage_element("T0_TAPE", "T0")
    g.add_storage_element("T1_DATADISK", "T1")
    g.add_storage_element("T2_SCRATCH", "T2")
    n_wn = _n(rng, 1, 3)
    for w in range(n_wn):
        g.add_worker_node(f"t2-wn{w:02d}", "T2")
    bw0 = float(rng.uniform(150.0, 400.0))
    g.add_link("T0_TAPE", "T1_DATADISK", bw0, bg_mu=float(rng.uniform(0, 3)))
    g.add_link("T1_DATADISK", "T2_SCRATCH", 0.8 * bw0)
    for w in range(n_wn):
        g.add_link("T2_SCRATCH", f"t2-wn{w:02d}", 2.0 * bw0)
        g.add_link("T0_TAPE", f"t2-wn{w:02d}", 0.3 * bw0,
                   bg_mu=float(rng.uniform(0, 5)))
        g.add_link("T1_DATADISK", f"t2-wn{w:02d}", bw0)

    jobs: List[Job] = []
    n_jobs = _n(rng, 2, 4, scale)
    for j in range(n_jobs):
        wn = f"t2-wn{j % n_wn:02d}"
        accs: List[FileAccess] = []
        for _ in range(_n(rng, 2, 4)):
            size = float(rng.uniform(20.0, 250.0))
            release = int(rng.randint(0, 60))
            kind = rng.randint(3)
            if kind == 0:  # archive -> T1 disk, then staged down to the node
                accs.append(FileAccess(
                    Replica(size, "T0_TAPE"), AccessProfileKind.DATA_PLACEMENT,
                    "gsiftp", release_tick=release,
                    local_storage_element="T1_DATADISK",
                ))
            elif kind == 1:  # already resident on the T2 scratch
                accs.append(FileAccess(
                    Replica(size, "T2_SCRATCH"), AccessProfileKind.STAGE_IN,
                    "xrdcp", release_tick=release,
                ))
            else:  # stream across the WAN from the T1 replica
                accs.append(FileAccess(
                    Replica(size, "T1_DATADISK"), AccessProfileKind.REMOTE,
                    "webdav", release_tick=release,
                ))
        jobs.append(Job(wn, tuple(accs), name=f"t2job{j}"))
    return g, Campaign(tuple(jobs), name=f"multi-tier-{seed}")


@register_family("bursty")
def _bursty(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    """Heavy-tailed arrivals: lognormal inter-burst gaps, geometric burst
    sizes — the pathological load the periodic-wave generators never emit."""
    rng = np.random.RandomState(seed + 404)
    g = Grid()
    g.add_data_center("SRC")
    g.add_data_center("EDGE")
    g.add_storage_element("SRC_DATADISK", "SRC")
    g.add_worker_node("edge-wn00", "EDGE")
    g.add_link(
        "SRC_DATADISK", "edge-wn00",
        bandwidth=float(rng.uniform(100.0, 300.0)),
        bg_mu=float(rng.uniform(0.0, 3.0)),
        bg_update_period=int(rng.randint(16, 64)),
    )
    accs: List[FileAccess] = []
    t = 0
    for _ in range(_n(rng, 3, 6, scale)):
        t += int(np.clip(rng.lognormal(mean=3.0, sigma=1.0), 1, 600))
        burst = 1 + int(rng.geometric(p=0.45))
        for _ in range(burst):
            accs.append(FileAccess(
                Replica(float(rng.uniform(20.0, 200.0)), "SRC_DATADISK"),
                AccessProfileKind.REMOTE, "webdav", release_tick=t,
            ))
    job = Job("edge-wn00", tuple(accs), name="burst")
    return g, Campaign((job,), name=f"bursty-{seed}")


@register_family("asymmetric-wan")
def _asymmetric_wan(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    """Two sites pulling placements over opposite, independently parameterized
    uni-directional links (Fig. 3 shape), one campaign over both directions."""
    rng = np.random.RandomState(seed + 505)
    g = Grid()
    g.add_data_center("A")
    g.add_data_center("B")
    g.add_storage_element("A_DATADISK", "A")
    g.add_storage_element("B_DATADISK", "B")
    g.add_worker_node("a-wn00", "A")
    g.add_worker_node("b-wn00", "B")
    bw_ab = float(rng.uniform(150.0, 400.0))
    bw_ba = float(rng.uniform(40.0, 140.0))
    g.add_link("A_DATADISK", "B_DATADISK", bw_ab, bg_mu=float(rng.uniform(0, 2)))
    g.add_link("B_DATADISK", "A_DATADISK", bw_ba, bg_mu=float(rng.uniform(2, 8)))
    g.add_link("A_DATADISK", "a-wn00", 2 * bw_ab)
    g.add_link("B_DATADISK", "b-wn00", 2 * bw_ab)

    def pulls(src: str, dst: str, wn: str, name: str) -> Job:
        accs = []
        for _ in range(_n(rng, 2, 5, scale)):
            accs.append(FileAccess(
                Replica(float(rng.uniform(20.0, 250.0)), src),
                AccessProfileKind.DATA_PLACEMENT, "gsiftp",
                release_tick=int(rng.randint(0, 120)),
                local_storage_element=dst,
            ))
        return Job(wn, tuple(accs), name=name)

    jobs = (
        pulls("A_DATADISK", "B_DATADISK", "b-wn00", "pull-ab"),
        pulls("B_DATADISK", "A_DATADISK", "a-wn00", "pull-ba"),
    )
    return g, Campaign(jobs, name=f"asymmetric-wan-{seed}")


@register_family("mixed-bag")
def _mixed_bag(seed: int = 0, scale: float = 1.0) -> Tuple[Grid, Campaign]:
    """Jobs mixing all three access profiles on one two-site grid."""
    rng = np.random.RandomState(seed + 606)
    g = Grid()
    g.add_data_center("A")
    g.add_data_center("B")
    g.add_storage_element("seA", "A")
    g.add_storage_element("seB", "B")
    g.add_worker_node("wn0", "B")
    g.add_worker_node("wn1", "B")
    bw = float(rng.uniform(60.0, 250.0))
    g.add_link("seA", "seB", 2 * bw)
    g.add_link("seB", "wn0", 4 * bw)
    g.add_link("seB", "wn1", 4 * bw)
    g.add_link("seA", "wn0", bw, bg_mu=float(rng.uniform(0, 4)))
    g.add_link("seA", "wn1", bw, bg_mu=float(rng.uniform(0, 4)))

    jobs: List[Job] = []
    for j in range(_n(rng, 2, 3, scale)):
        wn = f"wn{j % 2}"
        accs: List[FileAccess] = []
        for _ in range(_n(rng, 2, 4)):
            size = float(rng.uniform(20.0, 300.0))
            release = int(rng.randint(0, 40))
            kind = rng.randint(3)
            if kind == 0:
                accs.append(FileAccess(
                    Replica(size, "seA"), AccessProfileKind.DATA_PLACEMENT,
                    "gsiftp", release_tick=release,
                    local_storage_element="seB",
                ))
            elif kind == 1:
                accs.append(FileAccess(
                    Replica(size, "seB"), AccessProfileKind.STAGE_IN,
                    "xrdcp", release_tick=release,
                ))
            else:
                accs.append(FileAccess(
                    Replica(size, "seA"), AccessProfileKind.REMOTE,
                    "webdav", release_tick=release,
                ))
        jobs.append(Job(wn, tuple(accs), name=f"j{j}"))
    return g, Campaign(tuple(jobs), name=f"mixed-bag-{seed}")
