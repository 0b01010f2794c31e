"""Data-access-profile optimization on top of the simulator.

The port of ``repro.core.scheduler`` (the paper's stated future work:
"evolutionary optimization of data access patterns in bags of jobs with the
objective to minimize the joint data transfer time", fitness from the
simulator):

- Every file access lists *candidate* realizations (profile x replica
  source).
- All candidates of all accesses are compiled into one **super-table**, and
  an assignment enables exactly one candidate per access through the
  engine's ``enabled`` mask.
- A (mu + lambda) evolutionary strategy mutates assignments; fitness is the
  simulated campaign makespan (plus a share of the mean transfer time). A
  whole population runs as one banked :meth:`Fleet.run` of the super-table
  with one mask per replica; one assignment (:func:`_fitness`) runs through
  the per-campaign :func:`engine.simulate`.

The RNG is the reference's: the same keys give the same population,
mutations and history.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.engine import DeviceLike, SimParams, SimSpec, simulate
from repro_torch.core.fleet import Fleet
from repro_torch.core.topology import Grid
from repro_torch.core.workload import (
    AccessProfileKind,
    Campaign,
    FileAccess,
    Job,
    LegTable,
    compile_campaign,
)

__all__ = [
    "CandidateAccess",
    "SuperTable",
    "build_super_table",
    "super_fleet",
    "evaluate_population",
    "optimize_profiles",
]


@dataclasses.dataclass(frozen=True)
class CandidateAccess:
    """One file access with its candidate realizations."""

    job: int  # job index within the bag
    candidates: Tuple[FileAccess, ...]


class SuperTable(NamedTuple):
    spec: SimSpec
    table: LegTable
    # candidate -> legs mapping (ragged, padded with -1): [n_access, n_cand, 2]
    cand_legs: np.ndarray
    n_access: int
    n_cand: int
    cands_per_access: np.ndarray  # [n_access] i64 actual candidate counts


def build_super_table(
    grid: Grid,
    worker_nodes: Sequence[str],
    accesses: Sequence[CandidateAccess],
    *,
    max_ticks: Optional[int] = None,
    device: DeviceLike = None,
) -> SuperTable:
    """Compile the union of all candidates into one leg table, its spec on
    ``device`` (default ``cuda``). Candidate ``k`` of access ``i`` maps to
    1 (remote or stage-in) or 2 (placement) legs; ``cand_legs[i, k]``
    holds their leg ids (-1 padding)."""
    n_jobs = max(a.job for a in accesses) + 1
    jobs_accs: List[List[FileAccess]] = [[] for _ in range(n_jobs)]
    # every candidate becomes a real access; compile_campaign numbers
    # observations job by job, each job's accesses in insertion order, so
    # this per-job record of (access, candidate) is the observation order
    per_job_pairs: List[List[Tuple[int, int]]] = [[] for _ in range(n_jobs)]
    for i, acc in enumerate(accesses):
        for k, cand in enumerate(acc.candidates):
            jobs_accs[acc.job].append(cand)
            per_job_pairs[acc.job].append((i, k))
    jobs = tuple(
        Job(worker_node=worker_nodes[j], accesses=tuple(a), name=f"job{j}")
        for j, a in enumerate(jobs_accs)
    )
    table = compile_campaign(grid, Campaign(jobs, name="super"))

    n_access = len(accesses)
    n_cand = max(len(a.candidates) for a in accesses)
    cand_legs = np.full((n_access, n_cand, 2), -1, np.int64)
    # candidate (i, k) takes one observation (remote or stage-in: one leg)
    # or two (placement: the SE->SE leg, then its dependent stage-in leg)
    legs_by_obs: List[List[int]] = [[] for _ in range(int(table.obs_id.max()) + 1)]
    for leg, obs in enumerate(table.obs_id):
        legs_by_obs[int(obs)].append(leg)
    obs_ptr = 0
    for pairs in per_job_pairs:
        for (i, k) in pairs:
            cand = accesses[i].candidates[k]
            n_obs = 2 if cand.profile is AccessProfileKind.DATA_PLACEMENT else 1
            legs: List[int] = []
            for _ in range(n_obs):
                legs.extend(legs_by_obs[obs_ptr])
                obs_ptr += 1
            for s, leg in enumerate(legs[:2]):
                cand_legs[i, k, s] = leg
    return SuperTable(
        spec=SimSpec.from_table(table, max_ticks=max_ticks, device=device),
        table=table,
        cand_legs=cand_legs,
        n_access=n_access,
        n_cand=n_cand,
        cands_per_access=np.array([len(a.candidates) for a in accesses], np.int64),
    )


def _assignment_mask(st: SuperTable, assign: torch.Tensor) -> torch.Tensor:
    """Assignments ``[n_access]`` (or a population ``[B, n_access]``) ->
    enabled masks over the legs, ``[T]`` (or ``[B, T]``) bool."""
    n_legs = st.table.n_legs
    dev = assign.device
    assign = assign.long() % torch.as_tensor(st.cands_per_access, device=dev)
    cand_legs = torch.as_tensor(st.cand_legs, device=dev)  # [A, K, 2]
    chosen = cand_legs[torch.arange(st.n_access, device=dev), assign]  # [..., A, 2]
    flat = chosen.flatten(-2)
    flat = torch.where(flat >= 0, flat, n_legs)
    mask = torch.zeros(flat.shape[:-1] + (n_legs + 1,), dtype=torch.bool, device=dev)
    return mask.scatter(-1, flat, True)[..., :n_legs]


def _mask_fitness(
    res, mask: torch.Tensor, makespan_weight: float, mean_weight: float
) -> torch.Tensor:
    """Fitness of simulated legs under an enabled mask; every reduction runs
    over the trailing leg axis, so one formula scores one assignment
    (``[T]`` fields) or a population (``[B, T]``)."""
    m = mask.to(torch.float32)
    t_end = res.start_tick + res.transfer_time
    makespan = torch.amax(t_end * m, dim=-1)
    mean_t = torch.sum(res.transfer_time * m, dim=-1) / torch.clamp_min(
        torch.sum(m, dim=-1), 1.0
    )
    # unfinished legs dominate the penalty
    unfinished = torch.sum(~res.done & (m > 0), dim=-1)
    return (
        makespan_weight * makespan
        + mean_weight * mean_t
        + 1e6 * unfinished.to(torch.float32)
    )


def _fitness(
    st: SuperTable,
    base_params: SimParams,
    assign: torch.Tensor,
    key: torch.Tensor,
    makespan_weight: float = 1.0,
    mean_weight: float = 0.1,
) -> torch.Tensor:
    """Fitness of one assignment: one :func:`engine.simulate` of the
    super-table with its enabled mask."""
    dev = st.spec.device
    mask = _assignment_mask(st, assign.to(dev))
    params = SimParams(
        keep_frac=base_params.keep_frac, bg_mu=base_params.bg_mu,
        bg_sigma=base_params.bg_sigma, enabled=mask,
    )
    res = simulate(st.spec, params, key.to(dev))
    return _mask_fitness(res, mask, makespan_weight, mean_weight)


def super_fleet(st: SuperTable) -> Fleet:
    """The single-scenario :class:`Fleet` view of a super-table, on its
    spec's device: population fitness is a bank of one scenario whose ``B``
    candidate ``enabled`` masks ride the replica axis."""
    return Fleet.from_table(
        st.table, name="super", max_ticks=int(st.spec.max_ticks), device=st.spec.device
    )


def evaluate_population(
    st: SuperTable,
    base_params: SimParams,
    pop: torch.Tensor,  # [B, n_access] candidate assignments
    keys: torch.Tensor,  # [B, 2]
    *,
    makespan_weight: float = 1.0,
    mean_weight: float = 0.1,
    fleet: Optional[Fleet] = None,
) -> torch.Tensor:
    """Fitness ``[B]`` of a whole population in **one banked run**: every
    member shares the super-table and differs only in its ``enabled``
    mask, so the population is one :meth:`Fleet.run` of ``[1, B, ...]``
    (the masks are per-replica params of the single scenario)."""
    fleet = fleet if fleet is not None else super_fleet(st)
    dev = fleet.device
    masks = _assignment_mask(st, pop.to(dev))  # [B, T]
    f = lambda x: torch.as_tensor(x, device=dev)[None]
    params = SimParams(
        keep_frac=f(base_params.keep_frac),  # [1, T] shared
        bg_mu=f(base_params.bg_mu),
        bg_sigma=f(base_params.bg_sigma),
        enabled=masks[None],  # [1, B, T]: one mask per replica
    )
    res = fleet.run(params, keys=keys.to(dev)[None])
    res = type(res)(*(x[0] for x in res))  # back to [B, ...]
    return _mask_fitness(res, masks, makespan_weight, mean_weight)


def optimize_profiles(
    st: SuperTable,
    base_params: SimParams,
    key: torch.Tensor,
    *,
    population: int = 32,
    generations: int = 12,
    elite: int = 8,
    mutate_p: float = 0.15,
    antithetic_sims: int = 1,
) -> Tuple[np.ndarray, float, List[float]]:
    """(mu + lambda) evolutionary search over candidate assignments.

    Returns (best assignment ``[n_access]``, best fitness, per-generation
    best)."""
    n_access, n_cand = st.n_access, st.n_cand
    fleet = super_fleet(st)  # compiled once, shared by every generation
    key = key.to(fleet.device)
    key, k0 = prng.split(key, 2)
    pop = prng.randint(k0, (population, n_access), 0, n_cand)

    def eval_pop(pop: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        fits = [
            evaluate_population(st, base_params, pop, prng.split(k, pop.shape[0]), fleet=fleet)
            for k in prng.split(key, antithetic_sims)
        ]
        return torch.stack(fits).mean(dim=0)

    def next_gen(pop: torch.Tensor, fit: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        order = torch.argsort(fit, stable=True)
        elites = pop[order[:elite]]
        k1, k2, k3 = prng.split(key, 3)
        parents = elites[prng.randint(k1, (population - elite,), 0, elite)]
        flip = prng.uniform(k2, parents.shape) < mutate_p
        rand = prng.randint(k3, parents.shape, 0, n_cand)
        children = torch.where(flip, rand, parents)
        return torch.cat([elites, children], dim=0)

    history: List[float] = []
    best_fit = np.inf
    best_assign = pop[0].cpu().numpy()
    for _ in range(generations):
        key, ke, kn = prng.split(key, 3)
        fit = eval_pop(pop, ke)
        i = int(torch.argmin(fit))
        if float(fit[i]) < best_fit:
            best_fit = float(fit[i])
            best_assign = pop[i].cpu().numpy()
        history.append(float(torch.min(fit)))
        pop = next_gen(pop, fit, kn)
    return best_assign, best_fit, history
