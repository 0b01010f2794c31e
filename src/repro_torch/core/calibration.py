"""Simulator calibration (paper Section 5).

The port of ``repro.core.calibration``, for one campaign and for a fleet:

1. **Presimulate** ``(theta, x_sim)`` tuples: theta from the uniform prior
   box (overhead, mu, sigma), stochastic simulations under it, the Eq.-1
   coefficients of each run's remote observations as ``x_sim``. For one
   campaign (:func:`presimulate`) each chunk of thetas is one
   :func:`engine.simulate_batch`; over a fleet (:func:`presimulate_bank`)
   one fleet run, with a ``scenario_id`` per tuple.
2. **Project** thetas and coefficients onto (0, 1).
3. **Train** the AALR classifier (:func:`classifier.train_classifier`).
4. **MCMC** over theta given ``x_true``; theta* is the per-axis density
   mode (:class:`AmortizedPosterior` serves every scenario from one net).
5. **Validate** (:func:`validate`, :func:`validate_bank`): stochastic runs
   under theta*, per-run Eq.-1 fits and Eq.-6 errors.

Everything runs on the device of the spec or fleet (``cuda`` by default).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mcmc as mcmc_lib
from repro_torch.core import prng
from repro_torch.core.classifier import ClassifierConfig, Params, train_classifier
from repro_torch.core.dataset import observations
from repro_torch.core.engine import SimParams, SimResult, SimSpec, resolve_device, simulate_batch
from repro_torch.core.regression import coefficient_error, fit_eq1
from repro_torch.core.workload import LegTable, ProfileTag, ScenarioBank, summary_features

log = logging.getLogger("repro_torch.calibration")

__all__ = [
    "PriorBox",
    "CalibrationConfig",
    "CalibrationResult",
    "AmortizedPosterior",
    "simulate_coefficients",
    "presimulate",
    "presimulate_bank",
    "make_bank_theta_mapper",
    "calibrate",
    "validate",
    "validate_bank",
    "make_theta_mapper",
]

class PriorBox(NamedTuple):
    """Uniform prior bounds over theta = (overhead, mu, sigma) (paper)."""

    low: torch.Tensor  # [3]
    high: torch.Tensor  # [3]

    @staticmethod
    def paper(device=None) -> "PriorBox":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return PriorBox(low=f([0.0, 0.0, 0.0]), high=f([0.1, 100.0, 100.0]))

    def to(self, device) -> "PriorBox":
        return PriorBox(self.low.to(device), self.high.to(device))

    def to_unit(self, theta: torch.Tensor) -> torch.Tensor:
        return (theta - self.low) / (self.high - self.low)

    def from_unit(self, u: torch.Tensor) -> torch.Tensor:
        return self.low + u * (self.high - self.low)


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    n_presim: int = 65_536  # paper: 12.7M
    epochs: int = 30  # paper: 263
    batch_size: int = 4096
    lr: float = 1e-4  # paper: ADAM 0.0001
    n_replicates: int = 1  # paper-faithful: single-realization coefficients
    n_chains: int = 8
    n_mcmc: int = 20_000  # paper: 1M (+100k burn-in)
    burn_in: int = 2_000
    step_size: float = 0.05
    n_validation: int = 256  # paper: 16k stochastic validation sims
    use_leap: bool = True  # exact event-leap engine
    adaptive_mcmc: bool = True  # Robbins-Monro step adaptation in burn-in
    # fixed projection bounds of the coefficient space (x), so that the
    # classifier's input normalization does not depend on the data
    x_low: Tuple[float, float, float] = (-0.10, -0.10, -0.05)
    x_high: Tuple[float, float, float] = (0.25, 0.20, 0.06)


class CalibrationResult(NamedTuple):
    theta_star: torch.Tensor  # [3] per-axis marginal modes (physical units)
    theta_map: torch.Tensor  # [3] ratio-argmax MAP estimate
    posterior_samples: torch.Tensor  # [N, 3] physical units
    accept_rate: torch.Tensor
    classifier_params: Params
    x_true: torch.Tensor  # [3]
    rhat: Optional[torch.Tensor] = None  # [3] split-R-hat


def _warn_rhat(rhat: torch.Tensor, what: str) -> None:
    worst = float(rhat.max())
    if worst > 1.2:
        log.warning("%s may not have converged (max R-hat %.2f) — increase "
                    "n_mcmc/burn_in", what, worst)


@dataclasses.dataclass
class AmortizedPosterior:
    """One scenario-conditioned AALR posterior serving every scenario.

    Made by ``calibrate(..., amortized=True)`` / ``Fleet.calibrate(
    amortized=True)``: one conditional ratio net ``log r(x | theta, s)``
    trained over the whole presimulation fleet, the per-scenario context
    table and the prior. A scenario's posterior is an MCMC over the fixed
    net; scenarios are addressed by bank index or name.
    """

    classifier_params: Params
    features: torch.Tensor  # [N, F] unit-projected scenario context table
    prior: PriorBox
    x_true_unit: torch.Tensor  # [3] shared or [N, 3] per-scenario observation
    cfg: CalibrationConfig
    scenario_names: Tuple[str, ...]
    train_loss: float = float("nan")
    train_accuracy: float = float("nan")

    @property
    def n_scenarios(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.features.shape[1])

    def _index(self, scenario) -> int:
        if isinstance(scenario, str):
            try:
                return self.scenario_names.index(scenario)
            except ValueError:
                raise KeyError(
                    f"unknown scenario {scenario!r}; known: {list(self.scenario_names)}"
                ) from None
        i = int(scenario)
        if not 0 <= i < self.n_scenarios:
            raise IndexError(f"scenario {i} out of range for {self.n_scenarios} scenarios")
        return i

    def _x_rows(self) -> torch.Tensor:  # [N, 3]
        x = self.x_true_unit
        return x if x.dim() == 2 else x[None].expand(self.n_scenarios, x.shape[-1])

    def _key(self, key: Optional[torch.Tensor]) -> torch.Tensor:
        dev = self.features.device
        return prng.PRNGKey(0, dev) if key is None else key.to(dev)

    def _batched(self, idx: torch.Tensor, keys: torch.Tensor, n_samples, burn_in):
        cfg = self.cfg
        return mcmc_lib.run_chains_batched(
            self.classifier_params, self._x_rows()[idx], keys,
            n_chains=cfg.n_chains,
            n_samples=cfg.n_mcmc if n_samples is None else n_samples,
            burn_in=cfg.burn_in if burn_in is None else burn_in,
            step_size=cfg.step_size, adaptive=cfg.adaptive_mcmc,
            context=self.features[idx],
        )

    def mcmc(
        self,
        scenario,
        key: Optional[torch.Tensor] = None,
        *,
        n_samples: Optional[int] = None,
        burn_in: Optional[int] = None,
    ) -> Tuple[mcmc_lib.MCMCResult, torch.Tensor]:
        """Raw conditional chains for one scenario: the pooled unit-box
        :class:`~repro_torch.core.mcmc.MCMCResult` and the split-R-hat."""
        i = self._index(scenario)
        idx = torch.tensor([i], device=self.features.device)
        samples, rate, lrs, rhat = self._batched(idx, self._key(key)[None], n_samples, burn_in)
        d = samples.shape[-1]
        return mcmc_lib.MCMCResult(
            samples=samples[0].reshape(-1, d), accept_rate=rate[0],
            log_ratios=lrs[0].reshape(-1),
        ), rhat[0]

    def sample(self, scenario, key: Optional[torch.Tensor] = None, **mcmc_opts) -> torch.Tensor:
        """Posterior samples for one scenario in physical units ``[S, 3]``."""
        res, _ = self.mcmc(scenario, key, **mcmc_opts)
        return self.prior.from_unit(res.samples)

    def theta_star(self, scenario, key: Optional[torch.Tensor] = None, **mcmc_opts) -> torch.Tensor:
        """Per-axis marginal posterior modes (the paper's theta*) for one
        scenario, in physical units ``[3]``."""
        res, rhat = self.mcmc(scenario, key, **mcmc_opts)
        _warn_rhat(rhat, f"amortized MCMC for scenario {scenario!r}")
        return self.prior.from_unit(mcmc_lib.posterior_mode(res.samples))

    def theta_star_all(
        self,
        key: Optional[torch.Tensor] = None,
        *,
        n_samples: Optional[int] = None,
        burn_in: Optional[int] = None,
        return_stats: bool = False,
    ):
        """theta* of every scenario, ``[N, 3]`` physical units: scenario
        ``i`` is ``theta_star(i, fold_in(key, i))``, all scenarios' chains
        run as one batch of ``N * n_chains`` rows (one kernel launch per
        step). Feed it to ``Fleet.validate``. With ``return_stats`` also a
        dict of the chains' ``accept_rate [N]`` and split-R-hat ``rhat [N,
        3]``."""
        key = self._key(key)
        n = self.n_scenarios
        idx = torch.arange(n, device=self.features.device)
        samples, rate, _, rhat = self._batched(idx, prng.fold_in(key[None], idx), n_samples, burn_in)
        _warn_rhat(rhat, "amortized MCMC (worst scenario)")
        pooled = samples.reshape(n, -1, samples.shape[-1])
        theta = self.prior.from_unit(mcmc_lib.posterior_mode(pooled))
        if return_stats:
            return theta, {"accept_rate": rate, "rhat": rhat}
        return theta


def _theta_to_params(keep: torch.Tensor, protocol_mask: torch.Tensor,
                     link_scale: torch.Tensor, theta) -> SimParams:
    """theta = (overhead, mu, sigma) onto SimParams: the calibrated
    protocol's legs get the overhead, every valid link the background-load
    moments. Per campaign (``keep``/``mask`` ``[T]``, ``link_scale`` ones
    ``[L]``), where ``theta`` may be ``[3]`` or one per simulation ``[B,
    3]`` (the fields then ``[B, T]`` / ``[B, L]``); or bank-wide (``[N, T]``
    / ``[N, L]``, ``link_scale`` the link validity mask), where ``theta``
    may be ``[3]`` or per scenario ``[N, 3]`` (row ``i`` parameterizes
    scenario ``i``)."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=keep.device)
    if theta.dim() == 2:
        if protocol_mask.dim() == 2 and theta.shape[0] != protocol_mask.shape[0]:
            raise ValueError(
                f"per-scenario theta {tuple(theta.shape)} needs a bank-wide mapper "
                f"over {protocol_mask.shape[0] if protocol_mask.dim() == 2 else 1} "
                "scenarios"
            )
        overhead, mu, sigma = theta[:, 0:1], theta[:, 1:2], theta[:, 2:3]
    else:
        overhead, mu, sigma = theta[0], theta[1], theta[2]
    return SimParams(
        keep_frac=torch.where(protocol_mask, 1.0 - overhead, keep),
        bg_mu=mu * link_scale,
        bg_sigma=sigma * link_scale,
    )


def make_theta_mapper(source, protocol: str = "webdav", *, missing_ok: bool = False,
                      device=None):
    """``f(theta) -> SimParams`` for ``source``: a :class:`LegTable`
    (per-campaign params), a :class:`ScenarioBank` (bank-wide params) or a
    :class:`~repro_torch.core.fleet.Fleet` (its bank, on its device). An
    unknown ``protocol`` raises unless ``missing_ok``, which maps it to an
    all-False overhead mask."""
    from repro_torch.core.fleet import Fleet  # fleet sits above this module

    if isinstance(source, Fleet):
        device = source.device if device is None else device
        source = source.bank
    if not isinstance(source, (ScenarioBank, LegTable)):
        raise TypeError(
            f"make_theta_mapper needs a LegTable, ScenarioBank, or Fleet: {type(source)!r}"
        )
    dev = resolve_device(device)
    pid_arr = np.asarray(source.protocol_id)
    if protocol in source.protocol_names:
        mask = pid_arr == source.protocol_names.index(protocol)
    elif missing_ok:
        mask = np.zeros(pid_arr.shape, bool)
    else:
        raise ValueError(
            f"protocol {protocol!r} not in {source.protocol_names} "
            "(missing_ok=True maps it to a no-op overhead mask)"
        )
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).to(dev)
    keep = t(source.keep_frac, np.float32)
    if isinstance(source, ScenarioBank):
        link_scale = t(source.link_valid, np.float32)
    else:
        link_scale = torch.ones((source.n_links,), dtype=torch.float32, device=dev)
    return functools.partial(_theta_to_params, keep, t(mask, bool), link_scale)


def make_bank_theta_mapper(bank, protocol: str = "webdav", device=None):
    """Deprecated alias: :func:`make_theta_mapper` takes banks (and
    fleets) directly."""
    return make_theta_mapper(bank, protocol, device=device)


def _eq1_coefficients(res: SimResult) -> torch.Tensor:
    """The paper's summary statistic, batched: Eq.-1 OLS coefficients of the
    remote observations of each run, ``[..., 3]`` for a ``[..., T]`` result
    (padded legs carry ``profile=-1`` and drop out with the profile
    filter; unfinished legs drop out by their zero weight)."""
    ds = observations(res, ProfileTag.REMOTE)
    valid = ds.valid * res.done.to(ds.valid.dtype)
    return fit_eq1(ds.transfer_time, ds.size_mb, ds.conth_mb, ds.conpr_mb, valid).coef


def _replicated_coefficients(
    spec: SimSpec, params: SimParams, keys: torch.Tensor, n_replicates: int, leap: bool
) -> torch.Tensor:
    """Eq.-1 coefficients ``[B, 3]`` of ``B`` simulations (one key each,
    ``params`` shared or one row per key), each the mean over
    ``n_replicates`` replicates keyed ``split(key, n_replicates)``: all
    ``B * n_replicates`` runs as one :func:`engine.simulate_batch`."""
    if n_replicates == 1:
        return _eq1_coefficients(simulate_batch(spec, params, keys, leap=leap))
    B = keys.shape[0]
    rep = lambda f: f if f is None or f.dim() < 2 else f.repeat_interleave(n_replicates, 0)
    res = simulate_batch(
        spec, SimParams(*(rep(f) for f in params)),
        prng.split(keys, n_replicates).reshape(B * n_replicates, 2), leap=leap,
    )
    return _eq1_coefficients(res).reshape(B, n_replicates, 3).mean(dim=1)


def simulate_coefficients(
    spec: SimSpec,
    params: SimParams,
    key: torch.Tensor,
    *,
    n_replicates: int = 1,
    leap: bool = False,
) -> torch.Tensor:
    """Stochastic simulation(s) of one campaign -> Eq.-1 coefficient triple
    ``[3]``. ``n_replicates > 1`` averages the coefficients of independent
    simulations under the same theta, keyed ``split(key, n_replicates)``."""
    key = key.to(spec.device).reshape(1, 2)
    return _replicated_coefficients(spec, params, key, n_replicates, leap)[0]


def presimulate(
    spec: SimSpec,
    theta_mapper,
    prior: PriorBox,
    key: torch.Tensor,
    n: int,
    *,
    batch: int = 512,
    n_replicates: int = 1,
    leap: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw thetas from the prior and simulate their coefficient triples:
    ``(theta [n, 3], x_sim [n, 3])``, on the spec's device. Chunks of
    ``batch`` thetas, each one :func:`engine.simulate_batch` of ``batch *
    n_replicates`` runs, with the reference's keys: per chunk ``key, sub =
    split(key)``, ``kt, ks = split(sub)``, thetas from ``uniform(kt)``,
    one key per theta from ``split(ks, batch)``."""
    dev = spec.device
    prior = prior.to(dev)
    key = key.to(dev)
    outs_t, outs_x = [], []
    n_chunks = -(-n // batch)
    for i in range(n_chunks):
        key, sub = prng.split(key, 2)
        kt, ks = prng.split(sub, 2)
        thetas = prior.from_unit(prng.uniform(kt, (batch, 3)))
        x = _replicated_coefficients(
            spec, theta_mapper(thetas), prng.split(ks, batch), n_replicates, leap
        )
        outs_t.append(thetas)
        outs_x.append(x)
        if (i + 1) % max(n_chunks // 10, 1) == 0:
            log.info("presimulate: %d/%d chunks", i + 1, n_chunks)
    return torch.cat(outs_t)[:n], torch.cat(outs_x)[:n]


def validate(
    spec: SimSpec,
    table: LegTable,
    theta_star,
    x_true,
    key: torch.Tensor,
    *,
    n_sims: int = 256,
    protocol: str = "webdav",
    n_replicates: int = 1,
    leap: bool = True,
) -> dict:
    """Paper Fig. 6 / Table 1: ``n_sims`` stochastic simulations under
    theta* (keys ``split(key, n_sims)``, each the mean of ``n_replicates``),
    per-run Eq.-1 fits and Eq.-6 errors against ``x_true``. The reference
    maps the runs in batches of 64; they are independent, so one batch of
    all of them gives the same numbers."""
    dev = spec.device
    params = make_theta_mapper(table, protocol, device=dev)(theta_star)
    keys = prng.split(key.to(dev), n_sims)
    coefs = _replicated_coefficients(spec, params, keys, n_replicates, leap)
    x_ref = torch.as_tensor(x_true, dtype=torch.float32, device=dev)
    errors = coefficient_error(x_ref, coefs)
    np_ = lambda a: a.cpu().numpy()
    return {
        "coefficients": np_(coefs),
        "errors": np_(errors),
        "median_coef": np_(_median(coefs, 0)),
        "mean_abs_error": np_(errors.mean(0)),
        "sum_error": np_(errors.sum(1)),
    }


def _as_fleet(bank_or_fleet):
    from repro_torch.core.fleet import Fleet

    if isinstance(bank_or_fleet, Fleet):
        return bank_or_fleet
    return Fleet(bank_or_fleet)


def presimulate_bank(
    bank,
    prior: PriorBox,
    key: torch.Tensor,
    n_per_scenario: int,
    *,
    protocol: str = "webdav",
    batch: int = 128,
    leap: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(theta [n, 3], x_sim [n, 3], scenario_id [n] i32)`` tuples over the
    scenarios of ``bank`` (a bank or a :class:`Fleet`, whose device and
    ``leap`` default are used), ``n = n_scenarios * n_per_scenario``,
    scenario-major. Each chunk of ``batch`` draws per scenario is one fleet
    run with per-(scenario, draw) params and the reference's keys."""
    fleet = _as_fleet(bank)
    leap = fleet.leap if leap is None else leap
    bank = fleet.bank
    dev = fleet.device
    n_scn = bank.n_scenarios
    pid = bank.protocol_names.index(protocol)
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).to(dev)
    mask = t(bank.protocol_id == pid, bool)[:, None, :]  # [N, 1, T]
    keep = t(bank.keep_frac, np.float32)[:, None, :]
    link_valid = t(bank.link_valid, np.float32)[:, None, :]
    prior = prior.to(dev)
    key = key.to(dev)
    outs_t, outs_x = [], []
    for _ in range(-(-n_per_scenario // batch)):
        key, sub = prng.split(key, 2)
        kt, ks = prng.split(sub, 2)
        thetas = prior.from_unit(prng.uniform(kt, (n_scn, batch, 3)))
        keys = prng.split(ks, n_scn * batch).reshape(n_scn, batch, 2)
        params = SimParams(
            keep_frac=torch.where(mask, 1.0 - thetas[..., 0:1], keep),
            bg_mu=thetas[..., 1:2] * link_valid,
            bg_sigma=thetas[..., 2:3] * link_valid,
        )
        res = fleet.run(params, keys=keys, leap=leap)
        outs_t.append(thetas)
        outs_x.append(_eq1_coefficients(res))
    theta = torch.cat(outs_t, dim=1)[:, :n_per_scenario]
    x = torch.cat(outs_x, dim=1)[:, :n_per_scenario]
    scenario_id = torch.arange(n_scn, dtype=torch.int32, device=dev).repeat_interleave(n_per_scenario)
    return theta.reshape(-1, 3), x.reshape(-1, 3), scenario_id


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one), NaN where any value is NaN."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    mid = ((lo + hi) / 2).squeeze(dim)
    return torch.where(torch.isnan(x).any(dim), torch.full_like(mid, float("nan")), mid)


def validate_bank(
    bank,
    theta_star,
    x_true,  # [3] shared or [N, 3] per-scenario references
    key: torch.Tensor,
    *,
    n_sims: int = 64,
    protocol: str = "webdav",
    leap: Optional[bool] = None,
) -> dict:
    """Validation sweep: ``n_sims`` stochastic replicas of every scenario
    under theta* (``[3]`` or per scenario ``[N, 3]``), one fleet run, per-run
    Eq.-1 fits and Eq.-6 errors against ``x_true`` (broadcast the same
    way). ``leap=None`` takes the fleet's default (``True`` for a bare
    bank)."""
    fleet = _as_fleet(bank)
    if leap is None:
        leap = fleet.leap if fleet is bank else True
    bank = fleet.bank
    dev = fleet.device
    params = fleet.theta_mapper(protocol)(theta_star)
    n_scn = bank.n_scenarios
    keys = prng.split(key.to(dev), n_scn * n_sims).reshape(n_scn, n_sims, 2)
    res = fleet.run(params, keys=keys, leap=leap)
    coefs = _eq1_coefficients(res)  # [N, R, 3]
    x_ref = torch.as_tensor(x_true, dtype=torch.float32, device=dev)
    if x_ref.dim() == 1:
        x_ref = x_ref.expand(n_scn, 3)
    errors = coefficient_error(x_ref[:, None, :], coefs)  # [N, R, 3]
    np_ = lambda a: a.cpu().numpy()
    return {
        "coefficients": np_(coefs),
        "errors": np_(errors),
        "median_coef": np_(_median(coefs, 1)),  # [N, 3]
        "mean_abs_error": np_(errors.mean(1)),  # [N, 3]
        "sum_error": np_(errors.sum(2)),  # [N, R]
        "scenario_names": list(bank.names),
    }


def _feature_source(table) -> ScenarioBank:
    from repro_torch.core.fleet import Fleet

    if isinstance(table, Fleet):
        return table.bank
    if isinstance(table, ScenarioBank):
        return table
    raise TypeError(
        "amortized calibration needs a ScenarioBank/Fleet to derive scenario "
        f"features from (or an explicit features=[N, F] table); got {type(table)!r}"
    )


def calibrate(
    spec,
    table,
    x_true,
    key: torch.Tensor,
    cfg: CalibrationConfig = CalibrationConfig(),
    prior: Optional[PriorBox] = None,
    *,
    protocol: str = "webdav",
    presim: Optional[Tuple[torch.Tensor, ...]] = None,
    amortized: bool = False,
    features=None,
    stage=None,
):
    """Full likelihood-free calibration of (overhead, mu, sigma).

    With ``presim=None`` the tuples are presimulated first
    (:func:`presimulate` of ``spec`` under ``table``'s theta mapper,
    ``cfg.n_presim`` of them, ``cfg.n_replicates`` each, leap as
    ``cfg.use_leap`` says), on the spec's device. With ``presim = (theta,
    x_sim[, scenario_id])`` that stage is skipped, ``spec`` is unused and
    everything runs on the device of ``presim``. With ``amortized=True``
    the classifier is conditioned on each tuple's scenario context row
    (``features[scenario_id]``, by default :func:`summary_features` of
    ``table``, a bank or fleet) and an :class:`AmortizedPosterior` comes
    back; else the chains run at ``x_true`` and a
    :class:`CalibrationResult` comes back. ``stage(name)``, if given, is
    entered as a context manager around each stage (``"presimulate"``,
    ``"train"``, ``"mcmc"``): a caller's timer."""
    stage = stage or (lambda name: contextlib.nullcontext())
    dev = spec.device if presim is None else presim[0].device
    prior = (prior or PriorBox.paper()).to(dev)
    key, k_pre, k_train, k_mcmc = prng.split(key.to(dev), 4)

    scenario_id = None
    if presim is None:
        if amortized:
            raise ValueError(
                "amortized calibration needs presim=(theta, x_sim, "
                "scenario_id): presimulate over a fleet first "
                "(Fleet.calibrate(amortized=True) does both)"
            )
        log.info("presimulating %d tuples (x%d replicates)", cfg.n_presim, cfg.n_replicates)
        with stage("presimulate"):
            theta, x_sim = presimulate(
                spec, make_theta_mapper(table, protocol, device=dev), prior, k_pre,
                cfg.n_presim, n_replicates=cfg.n_replicates, leap=cfg.use_leap,
            )
    elif len(presim) == 3:
        theta, x_sim, scenario_id = presim
    else:
        theta, x_sim = presim
    if amortized and scenario_id is None:
        raise ValueError(
            "amortized calibration needs the scenario_id column: pass "
            "presim=(theta, x_sim, scenario_id)"
        )
    f32 = torch.float32
    x_low = torch.tensor(cfg.x_low, dtype=f32, device=dev)
    x_high = torch.tensor(cfg.x_high, dtype=f32, device=dev)
    proj_x = lambda x: torch.clamp((x - x_low) / (x_high - x_low), 0.0, 1.0)

    theta_u = prior.to_unit(theta)
    x_u = proj_x(x_sim)

    feats = context = None
    names = ()
    x_true = torch.as_tensor(x_true, dtype=f32, device=dev)
    if amortized:
        if features is not None:
            feats = torch.as_tensor(features, dtype=f32, device=dev)
            try:  # a bank or fleet still labels the scenarios
                names = tuple(_feature_source(table).names)
            except TypeError:
                names = ()
        else:
            source = _feature_source(table)
            feats = torch.as_tensor(np.asarray(summary_features(source), np.float32)).to(dev)
            names = tuple(source.names)
        if len(names) != feats.shape[0]:
            names = tuple(f"scenario{i}" for i in range(feats.shape[0]))
        scenario_id = scenario_id.to(dev).long()
        lo, hi = int(scenario_id.min()), int(scenario_id.max())
        if lo < 0 or hi >= feats.shape[0]:
            raise ValueError(
                f"scenario_id spans [{lo}, {hi}] but the feature table has "
                f"{feats.shape[0]} scenarios"
            )
        if x_true.dim() not in (1, 2) or x_true.shape[-1] != 3 or (
            x_true.dim() == 2 and x_true.shape[0] != feats.shape[0]
        ):
            raise ValueError(
                "amortized x_true must be one shared [3] observation or a "
                f"per-scenario [{feats.shape[0]}, 3] matrix; got shape "
                f"{tuple(x_true.shape)}"
            )
        context = feats[scenario_id]

    ctx_dim = 0 if feats is None else int(feats.shape[1])
    log.info("training %sAALR classifier (%d tuples, %d epochs)",
             "conditional " if amortized else "", theta.shape[0], cfg.epochs)
    clf_cfg = ClassifierConfig(theta_dim=3, x_dim=3, context_dim=ctx_dim, lr=cfg.lr)
    with stage("train"):
        params, metrics = train_classifier(
            k_train, clf_cfg, theta_u, x_u, context,
            epochs=cfg.epochs, batch_size=cfg.batch_size,
        )
    if amortized:
        return AmortizedPosterior(
            classifier_params=params,
            features=feats,
            prior=prior,
            x_true_unit=proj_x(x_true),
            cfg=cfg,
            scenario_names=names,
            train_loss=float(metrics.loss),
            train_accuracy=float(metrics.accuracy),
        )

    with stage("mcmc"):
        res, rhat = mcmc_lib.run_chains(
            params, proj_x(x_true), k_mcmc,
            n_chains=cfg.n_chains, n_samples=cfg.n_mcmc,
            burn_in=cfg.burn_in, step_size=cfg.step_size,
            adaptive=cfg.adaptive_mcmc,
        )
    log.info("mcmc accept rate: %.3f, split-R-hat: %s",
             float(res.accept_rate), rhat.cpu().numpy().round(3))
    _warn_rhat(rhat, "MCMC")
    theta_star = prior.from_unit(mcmc_lib.posterior_mode(res.samples))
    # the chain state with the largest ratio at x_true: a MAP estimate under
    # the uniform prior
    theta_map = prior.from_unit(res.samples[torch.argmax(res.log_ratios)])
    return CalibrationResult(
        theta_star=theta_star,
        theta_map=theta_map,
        posterior_samples=prior.from_unit(res.samples),
        accept_rate=res.accept_rate,
        classifier_params=params,
        x_true=x_true,
        rhat=rhat,
    )
