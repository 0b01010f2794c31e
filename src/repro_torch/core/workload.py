"""Workload model: replicas, access profiles, jobs, campaigns.

A campaign compiles into a dense **leg table**. A *leg* is one point-to-point
transfer over one link:

- ``remote`` access       -> 1 leg  (remote SE -> worker node, 1 thread of the
                                     job's streaming process on that link)
- ``stage-in``            -> 1 leg  (local SE -> worker node, own process)
- ``data-placement``      -> 2 legs (remote SE -> local SE placement leg with
                                     its own process, then a dependent
                                     stage-in leg local SE -> worker node)

Process semantics follow the paper exactly: when employing data-placement or
stage-in, *each file is transferred by an individual process*; a remote-access
job runs **one streaming process per (job, link)** whose concurrently active
legs are its *threads*.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import Grid, LinkTable

__all__ = [
    "AccessProfileKind",
    "Replica",
    "FileAccess",
    "Job",
    "Campaign",
    "LegTable",
    "ScenarioBank",
    "BankBucket",
    "BucketedBank",
    "compile_campaign",
    "compile_bank",
    "bank_from_tables",
    "subset_bank",
    "pad_bank_scenarios",
    "summary_features",
    "SUMMARY_FEATURE_NAMES",
    "wlcg_production_workload",
    "ProfileTag",
    "PAD_PROFILE",
    "PAD_PROTOCOL",
    "PAD_BG_PERIOD",
]

# Padding sentinels of the bank contract (see :class:`ScenarioBank`). The
# background period of a padded link must be huge, not 1: the event-leap
# engine leaps to the next background resample, and a period-1 phantom link
# would force it back to tick-by-tick stepping.
PAD_PROFILE = -1
PAD_PROTOCOL = -1
PAD_BG_PERIOD = 1 << 30

# --- bucket work-cost model (see compile_bank) -----------------------------
# Per-scenario cost ~= units * (_COST_STEP_BASE + pow2ceil(n_legs)): each
# engine iteration of a bucket costs a fixed base plus a term linear in the
# bucket's (power-of-two-bracketed) leg pad, and a scenario forces as many
# iterations as its own event count (leap) or fused-window count (tick).
# The constants were fitted on the standard 64-scenario fleet against
# measured per-bucket walls (c(S, T) ~ 6 + S*(6.4 + 0.28*T) us/iter plus a
# ~0.22 ms dispatch overhead per bucket program); only their *ratios*
# matter for packing, so they are dimensionless here.
_COST_STEP_BASE = 104.0
# Per-bucket fixed dispatch cost in the same units, added once per bucket
# when normalizing cost shares (a bucket is never cheaper than one dispatch).
_COST_DISPATCH_BASE = 1770.0
# Default budget slack for cost packing: a bucket may exceed the ideal
# equal-share cost by this factor before it is closed.
_DEFAULT_BUCKET_SLACK = 1.25


class AccessProfileKind(enum.Enum):
    DATA_PLACEMENT = "data-placement"
    STAGE_IN = "stage-in"
    REMOTE = "remote"


class ProfileTag:
    """Integer tags for per-leg profile labels in the compiled table."""

    PLACEMENT = 0  # remote SE -> local SE (gsiftp-style, own process)
    STAGE_IN = 1  # local SE -> WN scratch (xrdcp-style, own process)
    REMOTE = 2  # remote SE -> WN stream (webdav-style, thread of job process)


@dataclasses.dataclass(frozen=True)
class Replica:
    """A realization of a file persisted at a storage element."""

    size_mb: float
    storage_element: str

    def __post_init__(self) -> None:
        if self.size_mb <= 0:
            raise ValueError(f"replica size must be positive: {self.size_mb}")


@dataclasses.dataclass(frozen=True)
class FileAccess:
    """One input-file access of a job with a chosen access profile."""

    replica: Replica
    profile: AccessProfileKind
    protocol: str
    release_tick: int = 0
    # for DATA_PLACEMENT: which local SE receives the replica and which
    # protocol stages it into the worker node afterwards.
    local_storage_element: Optional[str] = None
    stagein_protocol: str = "xrdcp"


@dataclasses.dataclass(frozen=True)
class Job:
    """A computational job pinned to a worker node with assigned replicas."""

    worker_node: str
    accesses: Tuple[FileAccess, ...]
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Campaign:
    jobs: Tuple[Job, ...]
    name: str = "campaign"


@dataclasses.dataclass
class LegTable:
    """Dense arrays describing every transfer leg of a campaign.

    All arrays have length ``n_legs`` unless stated otherwise. One-hot
    incidence matrices are provided for the MXU-friendly segment reductions
    used by the tick engine / ``grid_tick`` kernel.
    """

    link_id: np.ndarray  # [T] i32
    proc_id: np.ndarray  # [T] i32 (dense process numbering)
    size_mb: np.ndarray  # [T] f32
    release: np.ndarray  # [T] i32 eligible tick
    dep: np.ndarray  # [T] i32 prerequisite leg id or -1
    keep_frac: np.ndarray  # [T] f32 = 1 - protocol overhead
    protocol_id: np.ndarray  # [T] i32 (index into protocol_names)
    profile: np.ndarray  # [T] i32 ProfileTag
    job_id: np.ndarray  # [T] i32
    obs_id: np.ndarray  # [T] i32 observation (file access) id
    protocol_names: List[str]
    links: LinkTable
    n_procs: int

    @property
    def n_legs(self) -> int:
        return int(self.link_id.shape[0])

    @property
    def n_links(self) -> int:
        return self.links.n_links

    # one-hot incidence matrices (float32) -------------------------------
    def leg_proc_onehot(self) -> np.ndarray:  # [T, P]
        m = np.zeros((self.n_legs, self.n_procs), np.float32)
        m[np.arange(self.n_legs), self.proc_id] = 1.0
        return m

    def proc_link_onehot(self) -> np.ndarray:  # [P, L]
        m = np.zeros((self.n_procs, self.n_links), np.float32)
        # every process lives on exactly one link by construction
        m[self.proc_id, self.link_id] = 1.0
        return m

    def leg_link_onehot(self) -> np.ndarray:  # [T, L]
        m = np.zeros((self.n_legs, self.n_links), np.float32)
        m[np.arange(self.n_legs), self.link_id] = 1.0
        return m

    def max_ticks_upper_bound(
        self,
        min_share_mb: float = 0.05,
        *,
        bg_headroom: float = 6.0,
        bg_override_cap: float = 256.0,
        slack: float = 2.0,
    ) -> int:
        """A safe cap on simulation length, bandwidth-aware.

        Work-conserving argument: at every tick before completion at least
        one released, unblocked leg transfers at no less than its *floor
        rate* ``keep * bandwidth / (procs_on_link + bg_cap) / threads_on_proc``
        (the fair share when every process of its link is active and the
        background load sits at ``bg_cap``), and ticks with no active leg
        only occur before the last release. Charging each tick to the first
        active leg bounds the total at ``release_max + sum_i
        ceil(size_i / floor_i)``; the sum is multiplied by ``slack`` and the
        result clamped by the legacy ``total / min_share_mb`` floor bound so
        the cap is never looser than before.

        ``bg_cap = max(mu + bg_headroom * sigma, bg_override_cap)``: the
        first term covers the compiled table's own stochastic draws, the
        ``bg_override_cap`` floor keeps default-compiled banks safe when
        **calibration overrides** the background moments — theta sweeps
        draw mu up to the paper prior's high of 100, far above any table's
        compiled moments, and a bound fitted only to the table would
        silently truncate exactly the bg-heavy region the posterior must
        resolve. (An unbounded Gaussian can always exceed any cap; extreme
        upper-tail draws may still truncate, and truncated legs are
        dropped from the regressions as before.)

        The tightening is what makes ``max_ticks`` bucketing meaningful:
        campaigns resolve bounds spread over orders of magnitude instead of
        everything saturating one global cap. Under ``leap=True`` the engine
        reaches any bound in O(#events) iterations, so a generous cap costs
        nothing at runtime — it only decides where truncated (never-
        finishing) simulations stop.
        """
        release_max = int(self.release.max())
        legacy = int(self.size_mb.sum() / min_share_mb) + release_max + 16

        links = self.links
        link_of_proc = np.zeros(self.n_procs, np.int64)
        link_of_proc[self.proc_id] = self.link_id
        procs_on_link = np.bincount(link_of_proc, minlength=self.n_links)
        threads_on_proc = np.bincount(self.proc_id, minlength=self.n_procs)
        bg_cap = np.maximum(
            links.bg_mu + bg_headroom * links.bg_sigma, bg_override_cap
        )
        denom = np.maximum(procs_on_link + bg_cap, 1.0)[self.link_id]
        floor = (
            self.keep_frac
            * links.bandwidth[self.link_id]
            / denom
            / np.maximum(threads_on_proc[self.proc_id], 1)
        )
        floor = np.maximum(floor, 1e-9)
        tight = (
            release_max
            + int(slack * np.ceil(self.size_mb / floor).sum())
            + 16
        )
        return max(1, min(legacy, tight))

    def leap_event_estimate(self) -> int:
        """Estimated event-leap iterations to finish this campaign.

        The leap engine advances each (scenario, replica) element to its own
        next event, so a campaign's iteration count tracks how many
        *distinct* completion/release events its legs generate, not its tick
        bound. Two regimes bracket it:

        - serial-ish campaigns finish one leg per few iterations:
          ``0.75 * n_legs + n_releases``;
        - wide parallel campaigns finish identical legs together, so the
          count collapses toward the number of distinct ``(release, size)``
          classes: ``0.9 * u_rs + n_releases + 2``.

        The minimum of the two matched measured leap-step counts within
        ~1.3x on the standard sampled fleet (steps 6-54), which is accurate
        enough for the work-cost bucket packing in :func:`compile_bank` —
        the estimate only needs to rank and roughly proportion scenarios.
        """
        rel = np.asarray(self.release)
        n_rel = len(np.unique(rel))
        u_rs = len(
            {(int(r), round(float(s), 4)) for r, s in zip(rel, self.size_mb)}
        )
        bound = min(0.75 * self.n_legs + n_rel, 0.9 * u_rs + n_rel + 2)
        return max(1, int(round(bound)))


def compile_campaign(grid: Grid, campaign: Campaign) -> LegTable:
    """Compile a campaign against a grid into the dense leg table."""
    link_table = grid.link_table()
    link_index = {name: i for i, name in enumerate(link_table.names)}
    proto_names = sorted(grid.protocols.keys())
    proto_index = {n: i for i, n in enumerate(proto_names)}

    link_id: List[int] = []
    proc_id: List[int] = []
    size_mb: List[float] = []
    release: List[int] = []
    dep: List[int] = []
    keep: List[float] = []
    proto_id: List[int] = []
    profile: List[int] = []
    job_id: List[int] = []
    obs_id: List[int] = []

    n_procs = 0
    n_obs = 0
    # remote-access streaming processes are shared per (job, link)
    for j, job in enumerate(campaign.jobs):
        stream_proc: Dict[int, int] = {}
        wn = job.worker_node
        for acc in job.accesses:
            rep = acc.replica
            proto = grid.protocols[acc.protocol]
            if acc.profile is AccessProfileKind.REMOTE:
                lid = link_index[(rep.storage_element, wn)]
                if lid not in stream_proc:
                    stream_proc[lid] = n_procs
                    n_procs += 1
                link_id.append(lid)
                proc_id.append(stream_proc[lid])
                size_mb.append(rep.size_mb)
                release.append(acc.release_tick)
                dep.append(-1)
                keep.append(1.0 - proto.overhead)
                proto_id.append(proto_index[acc.protocol])
                profile.append(ProfileTag.REMOTE)
                job_id.append(j)
                obs_id.append(n_obs)
                n_obs += 1
            elif acc.profile is AccessProfileKind.STAGE_IN:
                lid = link_index[(rep.storage_element, wn)]
                link_id.append(lid)
                proc_id.append(n_procs)
                n_procs += 1
                size_mb.append(rep.size_mb)
                release.append(acc.release_tick)
                dep.append(-1)
                keep.append(1.0 - proto.overhead)
                proto_id.append(proto_index[acc.protocol])
                profile.append(ProfileTag.STAGE_IN)
                job_id.append(j)
                obs_id.append(n_obs)
                n_obs += 1
            elif acc.profile is AccessProfileKind.DATA_PLACEMENT:
                local_se = acc.local_storage_element
                if local_se is None:
                    locals_ = grid.local_storage_elements(wn)
                    if not locals_:
                        raise ValueError(
                            f"no local storage element for worker node {wn!r}"
                        )
                    local_se = locals_[0]
                # leg 1: remote SE -> local SE, own process
                lid1 = link_index[(rep.storage_element, local_se)]
                placement_leg = len(link_id)
                link_id.append(lid1)
                proc_id.append(n_procs)
                n_procs += 1
                size_mb.append(rep.size_mb)
                release.append(acc.release_tick)
                dep.append(-1)
                keep.append(1.0 - proto.overhead)
                proto_id.append(proto_index[acc.protocol])
                profile.append(ProfileTag.PLACEMENT)
                job_id.append(j)
                obs_id.append(n_obs)
                n_obs += 1
                # leg 2: local SE -> WN, own process, depends on leg 1
                sproto = grid.protocols[acc.stagein_protocol]
                lid2 = link_index[(local_se, wn)]
                link_id.append(lid2)
                proc_id.append(n_procs)
                n_procs += 1
                size_mb.append(rep.size_mb)
                release.append(acc.release_tick)
                dep.append(placement_leg)
                keep.append(1.0 - sproto.overhead)
                proto_id.append(proto_index[acc.stagein_protocol])
                profile.append(ProfileTag.STAGE_IN)
                job_id.append(j)
                obs_id.append(n_obs)
                n_obs += 1
            else:  # pragma: no cover - enum exhaustive
                raise ValueError(f"unknown profile {acc.profile}")

    if not link_id:
        raise ValueError("campaign compiles to an empty leg table")

    return LegTable(
        link_id=np.array(link_id, np.int32),
        proc_id=np.array(proc_id, np.int32),
        size_mb=np.array(size_mb, np.float32),
        release=np.array(release, np.int32),
        dep=np.array(dep, np.int32),
        keep_frac=np.array(keep, np.float32),
        protocol_id=np.array(proto_id, np.int32),
        profile=np.array(profile, np.int32),
        job_id=np.array(job_id, np.int32),
        obs_id=np.array(obs_id, np.int32),
        protocol_names=proto_names,
        links=link_table,
        n_procs=n_procs,
    )


# ---------------------------------------------------------------------------
# ScenarioBank: many heterogeneous campaigns as one padded, stacked spec
# ---------------------------------------------------------------------------

def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _resolve_pads(
    tables: Sequence["LegTable"],
    pad_legs: Optional[int],
    pad_procs: Optional[int],
    pad_links: Optional[int],
    pad_multiple: int,
) -> Tuple[int, int, int]:
    """Padded (T, P, L): per-axis member maxima raised to the explicit
    floors and rounded to ``pad_multiple`` (floors are floors — content
    larger than a floor grows the pad). One resolver for every bank builder
    so banks from ``compile_bank`` and ``bank_from_tables`` share traces."""
    T = _round_up(max(max(t.n_legs for t in tables), pad_legs or 1), pad_multiple)
    P = _round_up(max(max(t.n_procs for t in tables), pad_procs or 1), pad_multiple)
    L = _round_up(max(max(t.n_links for t in tables), pad_links or 1), pad_multiple)
    return T, P, L


def _resolve_ticks(tables: Sequence["LegTable"], max_ticks) -> List[int]:
    """Per-scenario tick bounds: ``None`` -> safe upper bound, int ->
    uniform cap, sequence -> per-scenario caps (length-checked)."""
    n = len(tables)
    if max_ticks is None:
        return [t.max_ticks_upper_bound() for t in tables]
    if np.ndim(max_ticks) == 0:
        return [int(max_ticks)] * n
    if len(max_ticks) != n:
        raise ValueError(f"max_ticks: expected {n} entries, got {len(max_ticks)}")
    return [int(m) for m in max_ticks]


def _union_protocols(tables: Sequence["LegTable"]) -> List[str]:
    return sorted(set().union(*(t.protocol_names for t in tables)))


def _pow2ceil(n: int) -> int:
    t = 1
    while t < n:
        t *= 2
    return t


def _scenario_costs(
    tables: Sequence["LegTable"], expected: np.ndarray, *, leap: bool
) -> np.ndarray:
    """Per-scenario work-cost vector for bucket packing (see compile_bank).

    ``cost_i = units_i * (_COST_STEP_BASE + pow2ceil(n_legs_i))`` where
    ``units`` is the engine-iteration estimate: :meth:`LegTable.
    leap_event_estimate` under the leap engine, else the expected tick bound
    divided by the resolved fused window. The leg tier uses the power-of-two
    bracket because buckets of similar leg counts compile to the same padded
    program — the packing keys on ``(cost, n_legs)`` so leg-homogeneous
    scenarios land together and the tier is what their shared pad costs.
    """
    if leap:
        units = np.array(
            [t.leap_event_estimate() for t in tables], np.float64
        )
    else:
        # late import: engine imports workload at module level
        from repro_torch.core.engine import _resolve_window

        window = max(1, int(_resolve_window(None, False)))
        units = np.maximum(
            1.0, np.ceil(np.asarray(expected, np.float64) / window)
        )
    tier = np.array([_pow2ceil(t.n_legs) for t in tables], np.float64)
    return units * (_COST_STEP_BASE + tier)


def _pack_by_cost(
    costs: np.ndarray, legs: np.ndarray, n_buckets: int, slack: float
) -> List[np.ndarray]:
    """Greedy budgeted sweep in ascending (cost, n_legs) order.

    Buckets are closed when the next scenario would push their total past
    ``slack * total_cost / n_buckets``; a scenario whose own cost exceeds
    the budget becomes a singleton bucket (long-tail split). The realized
    bucket count is therefore *variable* — typically close to ``n_buckets``
    but free to differ so no bucket carries an outsized cost share.
    """
    n = len(costs)
    order = np.lexsort((np.arange(n), legs, costs))
    budget = float(slack) * float(costs.sum()) / max(1, int(n_buckets))
    groups: List[np.ndarray] = []
    cur: List[int] = []
    acc = 0.0
    for i in order:
        ci = float(costs[i])
        if cur and acc + ci > budget:
            groups.append(np.asarray(cur, np.int64))
            cur, acc = [], 0.0
        cur.append(int(i))
        acc += ci
        if ci > budget:  # long-tail split: singleton at native pads
            groups.append(np.asarray(cur, np.int64))
            cur, acc = [], 0.0
    if cur:
        groups.append(np.asarray(cur, np.int64))
    return groups


def _split_by_counts(
    order: np.ndarray, counts: Sequence[int], n: int
) -> List[np.ndarray]:
    """Split a packing order into explicitly-sized contiguous groups."""
    counts = [int(c) for c in counts]
    if any(c <= 0 for c in counts):
        raise ValueError(f"bucket_counts entries must be positive: {counts}")
    if sum(counts) != n:
        raise ValueError(
            f"bucket_counts sum to {sum(counts)}, expected {n} scenarios"
        )
    groups, pos = [], 0
    for c in counts:
        groups.append(np.asarray(order[pos : pos + c], np.int64))
        pos += c
    return groups


@dataclasses.dataclass
class ScenarioBank:
    """``N`` compiled ``(Grid, Campaign)`` pairs padded to shared shapes.

    Every scenario's leg table is embedded into ``[N, T]`` / ``[N, P]`` /
    ``[N, L]`` arrays (``T/P/L`` = the per-axis maxima across the bank,
    optionally rounded up), so a single jit trace of the engine serves every
    scenario shape up to the pad and heterogeneous banks of the same padded
    shape reuse the trace.

    Padding contract (semantically inert by construction):

    - padded **legs** carry ``size_mb=0``, ``dep=-1``, ``keep_frac=1``,
      ``profile=PAD_PROFILE``, ``protocol_id=PAD_PROTOCOL`` and an all-zero
      row in ``leg_proc`` / ``leg_link``; they are born done via
      ``leg_valid`` and never transfer, accumulate, or gate anything;
    - padded **processes** have all-zero ``proc_link`` rows, so they add no
      campaign load to any link;
    - padded **links** have ``bandwidth=0`` (zero fair share), zero
      background moments, and ``bg_period=PAD_BG_PERIOD`` so the event-leap
      engine never schedules a resample event for them;
    - ``max_ticks`` stays **per scenario**, so a bank run stops each
      scenario exactly where the per-scenario ``simulate()`` would.

    ``protocol_id`` is remapped onto the sorted union of all scenarios'
    protocol names (``protocol_names``), so one per-protocol override (e.g.
    the calibrated WebDAV overhead) applies bank-wide.
    """

    # stacked per-leg arrays [N, T]
    size_mb: np.ndarray
    release: np.ndarray
    dep: np.ndarray
    keep_frac: np.ndarray
    protocol_id: np.ndarray
    profile: np.ndarray
    leg_valid: np.ndarray  # bool
    # stacked incidence matrices
    leg_proc: np.ndarray  # [N, T, P] f32
    proc_link: np.ndarray  # [N, P, L] f32
    leg_link: np.ndarray  # [N, T, L] f32
    # stacked per-link arrays [N, L]
    bandwidth: np.ndarray
    bg_mu: np.ndarray
    bg_sigma: np.ndarray
    bg_period: np.ndarray
    link_valid: np.ndarray  # bool
    # per-scenario scalars [N]
    max_ticks: np.ndarray
    n_legs: np.ndarray
    n_procs: np.ndarray
    n_links: np.ndarray
    # metadata
    protocol_names: List[str]
    names: List[str]
    tables: List[LegTable]

    @property
    def n_scenarios(self) -> int:
        return int(self.size_mb.shape[0])

    @property
    def pad_legs(self) -> int:
        return int(self.size_mb.shape[1])

    @property
    def pad_procs(self) -> int:
        return int(self.proc_link.shape[1])

    @property
    def pad_links(self) -> int:
        return int(self.bandwidth.shape[1])

    def scenario_table(self, i: int) -> LegTable:
        """The unpadded source table of scenario ``i`` (oracle comparisons)."""
        if not self.tables:
            raise ValueError(
                "this bank carries no source tables (it was loaded from disk "
                "via Fleet.load); recompile the scenario for oracle comparisons"
            )
        return self.tables[i]


@dataclasses.dataclass
class BankBucket:
    """One work-cost-homogeneous sub-bank of a :class:`BucketedBank`.

    ``scenario_ids`` are the *original* bank indices (ascending), so slot
    ``s`` of ``bank`` is scenario ``scenario_ids[s]`` of the parent.

    ``cost`` is the bucket's total modelled work (sum of the members'
    per-scenario costs, see :func:`compile_bank`); ``cost_share`` is its
    dispatch-shifted fraction ``(cost + D0) / sum_b (cost_b + D0)`` of the
    whole bank's work — the expected fraction of bank wall time this bucket
    accounts for. Both are metadata: the engine ignores them, benchmarks
    use them to cost-normalize per-bucket throughput.
    """

    scenario_ids: np.ndarray  # [S_b] i32, ascending original indices
    bank: ScenarioBank  # sub-bank with its own (smaller) pads
    cost: float = 0.0  # modelled total work of the members
    cost_share: float = 0.0  # dispatch-shifted share of bank-wide work


@dataclasses.dataclass
class BucketedBank(ScenarioBank):
    """A :class:`ScenarioBank` whose scenarios are additionally grouped into
    ``max_ticks``-homogeneous sub-banks (see :func:`compile_bank`).

    The inherited stacked arrays keep the **original scenario order** and the
    global pads, so every params builder (``make_bank_params``, the bank theta
    mappers) and the monolithic engine path work unchanged. The engine's
    bucketed path runs each ``buckets[b].bank`` under its own cached trace and
    scatters results back into the caller's ``[N, R]`` order via the index
    map: scenario ``i`` lives at ``(bucket_of[i], slot_of[i])``.
    """

    bucket_of: np.ndarray  # [N] i32 bucket index per original scenario
    slot_of: np.ndarray  # [N] i32 slot within the bucket
    buckets: List[BankBucket]
    packing: str = "cost"  # bucket_packing mode the plan was built with

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def bucket_scenario_counts(self) -> Tuple[int, ...]:
        """Unpadded member count per bucket, in packed order.

        Feeding these back as ``compile_bank(..., bucket_counts=...)``
        reproduces this bank's grouping *sizes* exactly on another fleet,
        which (joined with matching ``bucket_pad_floors``) pins per-bucket
        trace shapes across fleets.
        """
        return tuple(len(b.scenario_ids) for b in self.buckets)


def _stack_tables(
    tables: Sequence[LegTable],
    names: Sequence[str],
    ticks: Sequence[int],
    T: int,
    P: int,
    L: int,
    proto_names: List[str],
) -> ScenarioBank:
    """Embed compiled leg tables into one ``[N, ...]`` padded stack (the
    shared worker behind the monolithic bank and each bucket's sub-bank;
    ``proto_names`` is the unified namespace protocol ids are remapped onto).
    """
    n = len(tables)
    proto_index = {p: i for i, p in enumerate(proto_names)}

    size_mb = np.zeros((n, T), np.float32)
    release = np.zeros((n, T), np.int32)
    dep = np.full((n, T), -1, np.int32)
    keep = np.ones((n, T), np.float32)
    proto_id = np.full((n, T), PAD_PROTOCOL, np.int32)
    profile = np.full((n, T), PAD_PROFILE, np.int32)
    leg_valid = np.zeros((n, T), bool)
    leg_proc = np.zeros((n, T, P), np.float32)
    proc_link = np.zeros((n, P, L), np.float32)
    leg_link = np.zeros((n, T, L), np.float32)
    bandwidth = np.zeros((n, L), np.float32)
    bg_mu = np.zeros((n, L), np.float32)
    bg_sigma = np.zeros((n, L), np.float32)
    bg_period = np.full((n, L), PAD_BG_PERIOD, np.int32)
    link_valid = np.zeros((n, L), bool)

    for i, t in enumerate(tables):
        nt, np_, nl = t.n_legs, t.n_procs, t.n_links
        size_mb[i, :nt] = t.size_mb
        release[i, :nt] = t.release
        dep[i, :nt] = t.dep
        keep[i, :nt] = t.keep_frac
        remap = np.array([proto_index[p] for p in t.protocol_names], np.int32)
        proto_id[i, :nt] = remap[t.protocol_id]
        profile[i, :nt] = t.profile
        leg_valid[i, :nt] = True
        leg_proc[i, :nt, :np_] = t.leg_proc_onehot()
        proc_link[i, :np_, :nl] = t.proc_link_onehot()
        leg_link[i, :nt, :nl] = t.leg_link_onehot()
        bandwidth[i, :nl] = t.links.bandwidth
        bg_mu[i, :nl] = t.links.bg_mu
        bg_sigma[i, :nl] = t.links.bg_sigma
        bg_period[i, :nl] = t.links.bg_period
        link_valid[i, :nl] = True

    return ScenarioBank(
        size_mb=size_mb,
        release=release,
        dep=dep,
        keep_frac=keep,
        protocol_id=proto_id,
        profile=profile,
        leg_valid=leg_valid,
        leg_proc=leg_proc,
        proc_link=proc_link,
        leg_link=leg_link,
        bandwidth=bandwidth,
        bg_mu=bg_mu,
        bg_sigma=bg_sigma,
        bg_period=bg_period,
        link_valid=link_valid,
        max_ticks=np.array(ticks, np.int32),
        n_legs=np.array([t.n_legs for t in tables], np.int32),
        n_procs=np.array([t.n_procs for t in tables], np.int32),
        n_links=np.array([t.n_links for t in tables], np.int32),
        protocol_names=proto_names,
        names=list(names),
        tables=list(tables),
    )


def compile_bank(
    pairs: Sequence[Tuple[Grid, Campaign]],
    *,
    max_ticks=None,
    pad_legs: Optional[int] = None,
    pad_procs: Optional[int] = None,
    pad_links: Optional[int] = None,
    pad_multiple: int = 1,
    n_buckets: int = 1,
    bucket_packing: str = "cost",
    bucket_slack: float = _DEFAULT_BUCKET_SLACK,
    bucket_cost_leap: bool = True,
    bucket_counts: Optional[Sequence[int]] = None,
    bucket_pad_floors: Optional[Sequence[Tuple[int, int, int]]] = None,
    shards: int = 1,
) -> ScenarioBank:
    """Compile heterogeneous ``(grid, campaign)`` pairs into one padded bank.

    ``max_ticks`` may be ``None`` (per-scenario safe upper bound), an int
    (uniform cap), or a per-scenario sequence. ``pad_*`` set explicit floors
    for the padded axes (so differently-sized banks can share a jit trace);
    ``pad_multiple`` rounds every padded axis up (e.g. 8 or 128 for
    lane-friendly kernel operands).

    **Shard-padding / device-placement contract** (``shards > 1``): each
    bucket's sub-bank has its scenario count rounded up to a multiple of
    ``shards`` with inert scenarios (:func:`pad_bank_scenarios` —
    ``max_ticks=0`` rows that are never live, so results are bitwise those
    of the unpadded bank), which lets the engine ``shard_map`` every
    bucket's program over a ``shards``-device mesh without an in-trace pad.
    Each bucket is partitioned **whole** across the mesh — every device
    holds ``S_b/shards`` scenarios of every bucket rather than whole
    buckets of one device — so the fused per-bucket windows and the
    scatter-back into the caller's ``[N, R]`` order stay device-local
    (collective-free) and every device sees the same per-bucket length
    distribution (no device idles on a short bucket while another grinds a
    long one). The engine drops the pad rows before the scatter, so they
    are invisible in results; ``Fleet.save``/``load`` preserves the padded
    per-bucket counts. The monolithic view is **never** shard-padded — its
    scenario count is caller-visible — and the engine instead pads it
    in-trace under the identical inert contract when run on a mesh.

    **Bucketing contract** (``n_buckets > 1`` returns a
    :class:`BucketedBank`): scenarios are grouped into sub-banks, each
    padded to **its own** member maxima (optionally raised by
    ``bucket_pad_floors[b] = (legs, procs, links)`` and rounded to
    ``pad_multiple``), and each engine trace runs only until the bucket's
    own slowest scenario finishes — no scenario ticks past its bucket's
    bound, which is what closes the warm-bank throughput gap of monolithic
    padding. The engine also resolves its fused tick window per bucket
    (capped at the bucket's tick bound's power-of-two bracket).

    How scenarios are grouped depends on ``bucket_packing``:

    - ``"cost"`` (default): each scenario is scored with the work-cost
      model ``cost_i = units_i * (_COST_STEP_BASE + pow2ceil(n_legs_i))``
      where ``units`` is the engine-iteration estimate
      (:meth:`LegTable.leap_event_estimate` when ``bucket_cost_leap``,
      else ``ceil(min(resolved, typical) / fused window)`` with the
      typical bound ``max_ticks_upper_bound(bg_override_cap=0.0)``).
      Scenarios are swept in ascending ``(cost, n_legs)`` order into
      buckets closed at the budget
      ``bucket_slack * total_cost / n_buckets``; a scenario whose own cost
      exceeds the budget becomes a **singleton long-tail bucket** at its
      native pads (the engine widens such buckets across the replica axis
      so their fused kernels still fill their tiles). Buckets are
      *variable-size* — the realized bucket count may differ from
      ``n_buckets`` — so bucket wall times equalize by total work, not by
      member count: no straggler bucket carries a multiple of the others'
      cost (the per-bucket warm-throughput spread this replaces was 4.4x).
    - ``"count"``: the legacy plan — sort by ``(min(resolved, typical),
      resolved, n_legs)`` and split into exactly ``n_buckets`` contiguous
      near-equal-count groups. Kept for comparison and for callers that
      need a fixed bucket count.

    ``bucket_counts`` overrides both: the active mode's packing *order* is
    split into exactly these group sizes (positive, summing to the fleet
    size). Feed one fleet's ``bucket_scenario_counts`` back through this to
    pin another same-size fleet to an identical plan, so per-bucket trace
    shapes (after joining ``bucket_pad_floors``) match across fleets.

    ``n_buckets`` larger than the fleet is clamped to the fleet size with a
    warning (every bucket a singleton) rather than rejected.

    Every bucket records its modelled ``cost`` and dispatch-shifted
    ``cost_share`` (under both packing modes) for cost-normalized
    throughput reporting; see :class:`BankBucket`.

    The **scenario index map is stable**: within each bucket, scenarios keep
    ascending original order, so ``bucket_of[i]`` / ``slot_of[i]`` are
    reproducible for a given fleet and the engine can scatter per-bucket
    results back into the caller's original ``[N, R]`` order. The inherited
    stacked arrays (and therefore every params builder) always use the
    original scenario order with the global pads; the global ``pad_*``
    floors apply only to that monolithic view, ``bucket_pad_floors`` only to
    the sub-banks (validated against the *realized* bucket count). Two
    fleets bucketed with the same plan sizes and matching bucket pad shapes
    reuse each bucket's jit trace (zero retraces — see
    ``benchmarks/bank_throughput.py``).
    """
    if not pairs:
        raise ValueError("compile_bank needs at least one (grid, campaign)")
    if shards < 1:
        raise ValueError(f"shards must be >= 1: {shards}")
    tables = [compile_campaign(g, c) for g, c in pairs]
    names = [c.name for _, c in pairs]
    n = len(tables)

    T, P, L = _resolve_pads(tables, pad_legs, pad_procs, pad_links, pad_multiple)
    proto_names = _union_protocols(tables)
    ticks = _resolve_ticks(tables, max_ticks)

    if n_buckets <= 1 and bucket_counts is None:
        return _stack_tables(tables, names, ticks, T, P, L, proto_names)

    if bucket_packing not in ("cost", "count"):
        raise ValueError(
            f"bucket_packing must be 'cost' or 'count': {bucket_packing!r}"
        )
    if n_buckets > n:
        warnings.warn(
            f"n_buckets={n_buckets} exceeds {n} scenarios; clamping to {n} "
            f"(every bucket a singleton)",
            stacklevel=2,
        )
        n_buckets = n

    # Work-cost scoring. The resolved cap is robust to calibration bg
    # overrides (see max_ticks_upper_bound's bg_override_cap) and therefore
    # a poor predictor of how long a scenario actually runs; the
    # table-typical bound (override cap 0 — the compiled moments only)
    # tracks realized length. Binding explicit caps still dominate via the
    # min. Costs are computed under *both* packing modes so every bucket
    # carries cost metadata.
    typical = np.array(
        [t.max_ticks_upper_bound(bg_override_cap=0.0) for t in tables],
        np.int64,
    )
    resolved = np.array(ticks, np.int64)
    expected = np.minimum(resolved, typical)
    legs = np.array([t.n_legs for t in tables], np.int64)
    costs = _scenario_costs(tables, expected, leap=bucket_cost_leap)

    if bucket_counts is not None:
        if bucket_packing == "cost":
            order = np.lexsort((np.arange(n), legs, costs))
        else:
            order = np.lexsort((legs, resolved, expected))
        groups = _split_by_counts(order, bucket_counts, n)
    elif bucket_packing == "cost":
        groups = _pack_by_cost(costs, legs, n_buckets, bucket_slack)
    else:
        order = np.lexsort((legs, resolved, expected))
        groups = [g for g in np.array_split(order, n_buckets) if len(g)]

    if bucket_pad_floors is not None and len(bucket_pad_floors) != len(groups):
        raise ValueError(
            f"bucket_pad_floors: expected {len(groups)} entries (the "
            f"realized bucket count), got {len(bucket_pad_floors)}"
        )

    shifted = np.array(
        [float(costs[g].sum()) + _COST_DISPATCH_BASE for g in groups]
    )
    shares = shifted / shifted.sum()

    bucket_of = np.zeros(n, np.int32)
    slot_of = np.zeros(n, np.int32)
    buckets: List[BankBucket] = []
    for b, group in enumerate(groups):
        ids = np.sort(group).astype(np.int32)  # stable: ascending originals
        bucket_of[ids] = b
        slot_of[ids] = np.arange(len(ids), dtype=np.int32)
        bt = [tables[i] for i in ids]
        fl, fp, fll = (
            bucket_pad_floors[b] if bucket_pad_floors is not None else (1, 1, 1)
        )
        Tb = _round_up(max(max(t.n_legs for t in bt), fl), pad_multiple)
        Pb = _round_up(max(max(t.n_procs for t in bt), fp), pad_multiple)
        Lb = _round_up(max(max(t.n_links for t in bt), fll), pad_multiple)
        sub = _stack_tables(
            bt, [names[i] for i in ids], [ticks[i] for i in ids],
            Tb, Pb, Lb, proto_names,
        )
        if shards > 1:
            sub = pad_bank_scenarios(sub, shards)
        buckets.append(
            BankBucket(
                scenario_ids=ids,
                bank=sub,
                cost=float(costs[ids].sum()),
                cost_share=float(shares[b]),
            )
        )

    # the monolithic view must dominate every bucket pad (the engine slices
    # bank-wide params down to each bucket's pads), so explicit
    # bucket_pad_floors grow the global pads too
    T = max(T, max(b.bank.pad_legs for b in buckets))
    P = max(P, max(b.bank.pad_procs for b in buckets))
    L = max(L, max(b.bank.pad_links for b in buckets))
    mono = _stack_tables(tables, names, ticks, T, P, L, proto_names)

    return BucketedBank(
        **{f.name: getattr(mono, f.name) for f in dataclasses.fields(ScenarioBank)},
        bucket_of=bucket_of,
        slot_of=slot_of,
        buckets=buckets,
        packing=bucket_packing,
    )


def bank_from_tables(
    tables: Sequence[LegTable],
    names: Optional[Sequence[str]] = None,
    *,
    max_ticks=None,
    pad_legs: Optional[int] = None,
    pad_procs: Optional[int] = None,
    pad_links: Optional[int] = None,
    pad_multiple: int = 1,
) -> ScenarioBank:
    """Stack already-compiled leg tables into one padded :class:`ScenarioBank`.

    The ``(grid, campaign)``-level twin of :func:`compile_bank` for callers
    that hold :class:`LegTable` objects (e.g. the scheduler's super-table):
    same padding contract, same unified protocol namespace, no recompile.
    """
    if not tables:
        raise ValueError("bank_from_tables needs at least one LegTable")
    tables = list(tables)
    n = len(tables)
    names = list(names) if names is not None else [f"table{i}" for i in range(n)]
    if len(names) != n:
        raise ValueError(f"names: expected {n} entries, got {len(names)}")
    T, P, L = _resolve_pads(tables, pad_legs, pad_procs, pad_links, pad_multiple)
    return _stack_tables(
        tables, names, _resolve_ticks(tables, max_ticks), T, P, L,
        _union_protocols(tables),
    )


def subset_bank(
    bank: ScenarioBank,
    scenario_ids: Sequence[int],
    *,
    pad_legs: Optional[int] = None,
    pad_procs: Optional[int] = None,
    pad_links: Optional[int] = None,
) -> ScenarioBank:
    """Slice scenarios out of a bank into a (possibly tighter-padded) bank.

    Because every stacked array keeps its scenario's content in the top-left
    corner and the padding values are position-independent constants, slicing
    rows and truncating the padded axes reproduces ``_stack_tables`` of the
    same scenarios bit for bit — this is how :meth:`Fleet.load` rebuilds each
    bucket's sub-bank from the persisted monolithic arrays. Target pads must
    dominate the member content and default to the parent's pads.
    """
    ids = np.asarray(scenario_ids, np.int64)
    T = bank.pad_legs if pad_legs is None else int(pad_legs)
    P = bank.pad_procs if pad_procs is None else int(pad_procs)
    L = bank.pad_links if pad_links is None else int(pad_links)
    if (
        T < int(bank.n_legs[ids].max())
        or P < int(bank.n_procs[ids].max())
        or L < int(bank.n_links[ids].max())
    ):
        raise ValueError(
            f"subset pads ({T}, {P}, {L}) cannot hold the selected scenarios"
        )
    if T > bank.pad_legs or P > bank.pad_procs or L > bank.pad_links:
        # slicing can only tighten pads; growing them would silently clamp
        raise ValueError(
            f"subset pads ({T}, {P}, {L}) exceed the parent pads "
            f"{(bank.pad_legs, bank.pad_procs, bank.pad_links)}; re-pad via "
            "compile_bank/bank_from_tables with explicit floors instead"
        )
    return ScenarioBank(
        size_mb=bank.size_mb[ids, :T],
        release=bank.release[ids, :T],
        dep=bank.dep[ids, :T],
        keep_frac=bank.keep_frac[ids, :T],
        protocol_id=bank.protocol_id[ids, :T],
        profile=bank.profile[ids, :T],
        leg_valid=bank.leg_valid[ids, :T],
        leg_proc=bank.leg_proc[ids, :T, :P],
        proc_link=bank.proc_link[ids, :P, :L],
        leg_link=bank.leg_link[ids, :T, :L],
        bandwidth=bank.bandwidth[ids, :L],
        bg_mu=bank.bg_mu[ids, :L],
        bg_sigma=bank.bg_sigma[ids, :L],
        bg_period=bank.bg_period[ids, :L],
        link_valid=bank.link_valid[ids, :L],
        max_ticks=bank.max_ticks[ids],
        n_legs=bank.n_legs[ids],
        n_procs=bank.n_procs[ids],
        n_links=bank.n_links[ids],
        protocol_names=list(bank.protocol_names),
        names=[bank.names[int(i)] for i in ids],
        tables=[bank.tables[int(i)] for i in ids] if bank.tables else [],
    )


def pad_bank_scenarios(
    bank: ScenarioBank,
    multiple: int = 1,
    *,
    count: Optional[int] = None,
) -> ScenarioBank:
    """Append inert scenarios until the scenario count hits ``count`` (or the
    next multiple of ``multiple``).

    The appended rows extend the bank's leg/link padding contract to whole
    scenarios: zero-size legs (all born done via ``leg_valid=False``),
    all-zero incidences, zero-bandwidth links with ``PAD_BG_PERIOD``, and —
    the scenario-level addition — ``max_ticks=0``, so a padded scenario is
    **never live**: the engine's per-scenario (and per-shard) loop
    conditions see it finished before the first tick and every window over
    it is a frozen bit-exact no-op. This is what makes shard padding
    results-invariant (see ``compile_bank(shards=...)`` and the engine's
    in-jit twin for monolithic banks).

    Pad scenarios are named ``__shard_pad__{i}`` and carry no source table
    (``scenario_table`` raises for them); all real rows are bit-identical
    slices of the input. ``n_legs``/``n_procs``/``n_links`` are 0 for pads.
    """
    n = bank.n_scenarios
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1: {multiple}")
    target = _round_up(n, multiple) if count is None else int(count)
    if target < n:
        raise ValueError(
            f"target scenario count {target} below the bank's {n}"
        )
    pad = target - n
    if pad == 0:
        return bank
    T, P, L = bank.pad_legs, bank.pad_procs, bank.pad_links

    def rows(fill, shape, dtype):
        return np.full((pad,) + shape, fill, dtype)

    cat = lambda a, b: np.concatenate([a, b], axis=0)
    return ScenarioBank(
        size_mb=cat(bank.size_mb, rows(0, (T,), np.float32)),
        release=cat(bank.release, rows(0, (T,), np.int32)),
        dep=cat(bank.dep, rows(-1, (T,), np.int32)),
        keep_frac=cat(bank.keep_frac, rows(1, (T,), np.float32)),
        protocol_id=cat(bank.protocol_id, rows(PAD_PROTOCOL, (T,), np.int32)),
        profile=cat(bank.profile, rows(PAD_PROFILE, (T,), np.int32)),
        leg_valid=cat(bank.leg_valid, rows(False, (T,), bool)),
        leg_proc=cat(bank.leg_proc, rows(0, (T, P), np.float32)),
        proc_link=cat(bank.proc_link, rows(0, (P, L), np.float32)),
        leg_link=cat(bank.leg_link, rows(0, (T, L), np.float32)),
        bandwidth=cat(bank.bandwidth, rows(0, (L,), np.float32)),
        bg_mu=cat(bank.bg_mu, rows(0, (L,), np.float32)),
        bg_sigma=cat(bank.bg_sigma, rows(0, (L,), np.float32)),
        bg_period=cat(bank.bg_period, rows(PAD_BG_PERIOD, (L,), np.int32)),
        link_valid=cat(bank.link_valid, rows(False, (L,), bool)),
        max_ticks=cat(bank.max_ticks, rows(0, (), np.int32)),
        n_legs=cat(bank.n_legs, rows(0, (), np.int32)),
        n_procs=cat(bank.n_procs, rows(0, (), np.int32)),
        n_links=cat(bank.n_links, rows(0, (), np.int32)),
        protocol_names=list(bank.protocol_names),
        names=list(bank.names) + [f"__shard_pad__{i}" for i in range(pad)],
        tables=list(bank.tables),
    )


# ---------------------------------------------------------------------------
# Scenario summary features (the amortized-calibration context vector)
# ---------------------------------------------------------------------------

#: Names of the per-scenario campaign summary features, in column order.
SUMMARY_FEATURE_NAMES = (
    "log1p_n_remote_legs",
    "log1p_n_stagein_legs",
    "log1p_n_placement_legs",
    "log1p_total_mb",
    "log1p_remote_mb",
    "log1p_n_links",
    "log1p_bw_mean",
    "log1p_bw_std",
    "log1p_max_ticks",
)

# Fixed, data-independent projection bounds onto (0, 1) — the context-space
# twin of ``CalibrationConfig.x_low/x_high``: a classifier trained on one
# fleet must see the same normalization when conditioned on any other
# fleet's scenarios, so the bounds cannot depend on the bank at hand. All
# features are log1p-compressed first; the highs cover ~1e5 legs, ~1e9 MB,
# ~1e4 links, ~1e7 MB/s link bandwidth, and ~1e9 ticks.
_SUMMARY_LOW = np.zeros(len(SUMMARY_FEATURE_NAMES), np.float32)
_SUMMARY_HIGH = np.array(
    [12.0, 12.0, 12.0, 21.0, 21.0, 10.0, 17.0, 17.0, 21.0], np.float32
)


def summary_features(bank: ScenarioBank) -> np.ndarray:
    """Per-scenario campaign summary features ``[N, F]`` projected to (0, 1).

    The scenario context vector of the amortized (scenario-conditioned) AALR
    calibration: per-profile leg counts, total/remote transferred bytes, link
    count, bandwidth moments over valid links, and the per-scenario
    ``max_ticks`` bound — every column ``log1p``-compressed and clipped onto
    (0, 1) with the fixed bounds above (see :data:`SUMMARY_FEATURE_NAMES`).

    Works on any bank layout: a monolithic :class:`ScenarioBank`, a
    :class:`BucketedBank` (its inherited stacked arrays keep the original
    scenario order, so no scatter is needed — bucket sub-banks agree column
    for column), and banks loaded from disk via ``Fleet.load`` (only the
    persisted dense arrays are touched, never the source tables).
    """
    lv = np.asarray(bank.leg_valid, bool)  # [N, T]
    prof = np.asarray(bank.profile)
    size = np.asarray(bank.size_mb, np.float64)
    linkv = np.asarray(bank.link_valid, bool)  # [N, L]
    bw = np.asarray(bank.bandwidth, np.float64)

    remote = lv & (prof == ProfileTag.REMOTE)
    stagein = lv & (prof == ProfileTag.STAGE_IN)
    placement = lv & (prof == ProfileTag.PLACEMENT)
    n_links = linkv.sum(axis=1)
    denom = np.maximum(n_links, 1).astype(np.float64)
    bw_mean = (bw * linkv).sum(axis=1) / denom
    bw_var = (((bw - bw_mean[:, None]) ** 2) * linkv).sum(axis=1) / denom
    raw = np.stack(
        [
            remote.sum(axis=1),
            stagein.sum(axis=1),
            placement.sum(axis=1),
            (size * lv).sum(axis=1),
            (size * remote).sum(axis=1),
            n_links,
            bw_mean,
            np.sqrt(np.maximum(bw_var, 0.0)),
            np.asarray(bank.max_ticks, np.float64),
        ],
        axis=1,
    )
    f = np.log1p(raw)
    unit = (f - _SUMMARY_LOW) / (_SUMMARY_HIGH - _SUMMARY_LOW)
    return np.clip(unit, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# The paper's production workload (Section 5)
# ---------------------------------------------------------------------------

def wlcg_production_workload(
    *,
    n_waves: int = 26,
    wave_period_ticks: int = 900,
    max_jobs: int = 12,
    max_threads: int = 4,
    min_size_mb: float = 300.0,
    max_size_mb: float = 3000.0,
    n_observations: int = 106,
    link_bandwidth: float = 1250.0,  # 10,000 Mbps estimate from the paper
    bg_update_period: int = 60,
    seed: int = 0,
) -> Tuple[Grid, Campaign]:
    """Reconstruct the WLCG production workload of Section 5.

    1-12 concurrent jobs on one CERN worker node initiate remote (WebDAV)
    accesses to ``GRIF-LPNHE_SCRATCHDISK`` once per 15 minutes during
    28.04.2018 00:00-06:15 (26 waves); each job streams up to 4 concurrent
    files of 300MB-3GB. Sampling stops at ``n_observations`` file accesses
    (the paper derives 106 observations).
    """
    rng = np.random.RandomState(seed)
    grid = Grid()
    grid.add_data_center("CERN")
    grid.add_data_center("GRIF-LPNHE")
    grid.add_storage_element("GRIF-LPNHE_SCRATCHDISK", "GRIF-LPNHE")
    grid.add_storage_element("CERN-PROD_SCRATCHDISK", "CERN")
    for j in range(max_jobs):
        grid.add_worker_node(f"cern-wn{j:02d}", "CERN")
    # one worker node hosts all jobs in the paper; jobs on the same node share
    # the node's WAN link. We model the shared node link explicitly:
    grid.add_link(
        "GRIF-LPNHE_SCRATCHDISK",
        "cern-wn00",
        bandwidth=link_bandwidth,
        bg_update_period=bg_update_period,
    )

    accesses_per_job: List[List[FileAccess]] = [[] for _ in range(max_jobs)]
    n_obs = 0
    for wave in range(n_waves):
        if n_obs >= n_observations:
            break
        t0 = wave * wave_period_ticks
        n_jobs = int(rng.randint(1, max_jobs + 1))
        for j in range(n_jobs):
            if n_obs >= n_observations:
                break
            n_threads = int(rng.randint(1, max_threads + 1))
            for _ in range(n_threads):
                if n_obs >= n_observations:
                    break
                size = float(rng.uniform(min_size_mb, max_size_mb))
                accesses_per_job[j].append(
                    FileAccess(
                        replica=Replica(size, "GRIF-LPNHE_SCRATCHDISK"),
                        profile=AccessProfileKind.REMOTE,
                        protocol="webdav",
                        release_tick=t0,
                    )
                )
                n_obs += 1

    jobs = tuple(
        Job(worker_node="cern-wn00", accesses=tuple(accs), name=f"job{j}")
        for j, accs in enumerate(accesses_per_job)
        if accs
    )
    return grid, Campaign(jobs=jobs, name="wlcg-prod-20180428")
