"""``repro_torch.Fleet``: compile a scenario fleet and simulate it.

The port's façade over :func:`workload.compile_bank` and
:func:`engine.simulate_bank`, mirroring the reference's ``repro.Fleet``:
:meth:`Fleet.from_pairs` / :meth:`Fleet.from_scenarios` compile a bank
(:meth:`Fleet.from_table` lifts one compiled campaign),
:meth:`Fleet.params` builds its parameters and :meth:`Fleet.run` simulates
it with the reference's replica-key schedule; :meth:`Fleet.run` also takes
a calibration theta (``[3]`` or per scenario ``[N, 3]``). The calibration
front-ends (:meth:`Fleet.coefficients`, :meth:`Fleet.presimulate`,
:meth:`Fleet.calibrate`, :meth:`Fleet.validate`) run through the banked
path of :mod:`repro_torch.core.calibration`. A fleet runs on ``device``
(default ``cuda``). ``stream``, ``save``/``load``, checkpoints and the
compile cache are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import calibration as calibration_lib
from repro_torch.core import prng
from repro_torch.core.engine import (
    DeviceLike,
    SimParams,
    SimResult,
    make_bank_params,
    resolve_device,
    simulate_bank,
)
from repro_torch.core.scenarios import sample_scenarios
from repro_torch.core.topology import Grid
from repro_torch.core.workload import (
    BucketedBank,
    Campaign,
    LegTable,
    ScenarioBank,
    bank_from_tables,
    compile_bank,
    summary_features,
)

__all__ = ["Fleet"]

PairsLike = Sequence[Tuple[Grid, Campaign]]
TicksLike = Union[None, int, Sequence[int], np.ndarray]
ParamsLike = Union[None, SimParams, torch.Tensor, Sequence[float], np.ndarray,
                   Callable[[ScenarioBank], SimParams]]


class Fleet:
    """A compiled scenario fleet with its run policy (leap, window, device).

    Construct with :meth:`from_pairs`, :meth:`from_scenarios`, or wrap a
    compiled bank: ``Fleet(bank)``.
    """

    def __init__(
        self,
        bank: ScenarioBank,
        *,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        if not isinstance(bank, ScenarioBank):
            raise TypeError(f"Fleet wraps a compiled ScenarioBank, got {type(bank)!r}")
        self.bank = bank
        self.leap = leap
        self.window = window
        self.device = resolve_device(device)
        self._base_params: Optional[SimParams] = None
        self._mappers: Dict[str, Callable[[Any], SimParams]] = {}

    @classmethod
    def from_pairs(
        cls,
        pairs: PairsLike,
        *,
        max_ticks: TicksLike = None,
        n_buckets: int = 1,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Compile ``(grid, campaign)`` pairs into a fleet. ``n_buckets > 1``
        compiles a bucketed bank (its bucketed dispatch is not ported yet),
        packed by the leap or tick cost model as ``leap`` says."""
        bank = compile_bank(
            list(pairs), max_ticks=max_ticks, n_buckets=n_buckets,
            bucket_cost_leap=leap,
        )
        return cls(bank, leap=leap, window=window, device=device)

    @classmethod
    def from_scenarios(
        cls,
        families: Optional[Sequence[str]] = None,
        n: int = 8,
        seed: int = 0,
        *,
        scale: float = 1.0,
        max_ticks: TicksLike = None,
        n_buckets: int = 1,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Sample ``n`` scenarios from the family registry (seeds ``seed``
        to ``seed + n - 1``) and compile them."""
        return cls.from_pairs(
            sample_scenarios(families, n, seed, scale=scale),
            max_ticks=max_ticks, n_buckets=n_buckets, leap=leap,
            window=window, device=device,
        )

    @classmethod
    def from_table(
        cls,
        table: LegTable,
        *,
        name: str = "table0",
        max_ticks: TicksLike = None,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Lift one compiled :class:`LegTable` into a single-scenario fleet
        (pads equal the table's own shape, so nothing is padded). This is
        how the scheduler runs population fitness as one banked batch:
        ``B`` ``enabled`` masks become per-replica params of the one
        scenario."""
        bank = bank_from_tables([table], [name], max_ticks=max_ticks)
        return cls(bank, leap=leap, window=window, device=device)

    @property
    def n_scenarios(self) -> int:
        return self.bank.n_scenarios

    @property
    def pads(self) -> Tuple[int, int, int]:
        """The ``(legs, procs, links)`` pad shape of the bank."""
        return (self.bank.pad_legs, self.bank.pad_procs, self.bank.pad_links)

    @property
    def n_buckets(self) -> int:
        return self.bank.n_buckets if isinstance(self.bank, BucketedBank) else 1

    def __repr__(self) -> str:
        return (
            f"Fleet({type(self.bank).__name__}: {self.n_scenarios} scenarios, "
            f"pads={self.pads}, buckets={self.n_buckets}, leap={self.leap}, "
            f"window={self.window}, device={self.device})"
        )

    def params(self, **overrides: Any) -> SimParams:
        """Bank-wide :class:`SimParams` on the fleet's device
        (:func:`engine.make_bank_params` knobs); the no-override params are
        memoized."""
        if not overrides:
            if self._base_params is None:
                self._base_params = make_bank_params(self.bank, device=self.device)
            return self._base_params
        return make_bank_params(self.bank, device=self.device, **overrides)

    def theta_mapper(self, protocol: str = "webdav") -> Callable[[Any], SimParams]:
        """The calibration mapper ``f(theta) -> SimParams`` over the whole
        bank, on the fleet's device (memoized per protocol)."""
        mapper = self._mappers.get(protocol)
        if mapper is None:
            mapper = calibration_lib.make_theta_mapper(self, protocol)
            self._mappers[protocol] = mapper
        return mapper

    def _resolve_params(self, params_or_theta: ParamsLike, protocol: str) -> SimParams:
        """``None`` -> the bank's params; ``SimParams`` -> as given; a
        callable -> ``params_or_theta(bank)``; a ``[3]`` theta or a
        per-scenario ``[N, 3]`` theta -> the calibration mapper."""
        if params_or_theta is None:
            return self.params()
        if isinstance(params_or_theta, SimParams):
            return params_or_theta
        if callable(params_or_theta):
            return params_or_theta(self.bank)
        theta = torch.as_tensor(params_or_theta, dtype=torch.float32)
        if tuple(theta.shape) not in ((3,), (self.n_scenarios, 3)):
            raise TypeError(
                "params_or_theta must be SimParams, a theta [3] vector, a "
                f"per-scenario theta [{self.n_scenarios}, 3] matrix, a "
                f"callable bank -> SimParams, or None; got shape {tuple(theta.shape)}"
            )
        return self.theta_mapper(protocol)(theta.to(self.device))

    def run(
        self,
        params_or_theta: ParamsLike = None,
        *,
        replicas: Optional[int] = None,
        key: Optional[torch.Tensor] = None,
        keys: Optional[torch.Tensor] = None,
        protocol: str = "webdav",
        leap: Optional[bool] = None,
        bucketed: bool = True,
        window: Optional[int] = None,
    ) -> SimResult:
        """Simulate every scenario x ``replicas`` stochastic replicas.

        ``params_or_theta`` is resolved by :meth:`_resolve_params` (a theta
        maps through :meth:`theta_mapper` for ``protocol``). Replica keys are
        split from ``key`` (default ``prng.PRNGKey(0)``) into ``[N, R, 2]``
        exactly as the reference's ``Fleet.run`` splits them, unless explicit
        ``keys`` are given (the replica count then comes from the keys).
        """
        params = self._resolve_params(params_or_theta, protocol)
        n = self.n_scenarios
        if keys is None:
            r = 1 if replicas is None else int(replicas)
            key = prng.PRNGKey(0, self.device) if key is None else key.to(self.device)
            keys = prng.split(key, n * r).reshape(n, r, 2)
        elif keys.dim() != 3 or keys.shape[0] != n:
            raise ValueError(f"keys must be [n_scenarios={n}, R, 2]: {tuple(keys.shape)}")
        elif replicas is not None and keys.shape[1] != replicas:
            raise ValueError(
                f"explicit keys carry {keys.shape[1]} replicas but "
                f"replicas={replicas} was requested"
            )
        return simulate_bank(
            self.bank,
            params,
            keys,
            leap=self.leap if leap is None else leap,
            bucketed=bucketed,
            window=self.window if window is None else window,
            device=self.device,
        )

    # -- calibrate ----------------------------------------------------------

    def coefficients(
        self,
        params_or_theta: ParamsLike = None,
        *,
        replicas: int = 1,
        key: Optional[torch.Tensor] = None,
        protocol: str = "webdav",
        leap: Optional[bool] = None,
    ) -> torch.Tensor:
        """Eq.-1 coefficient triples of a fleet run: ``[N, R, 3]`` (one OLS
        fit of the remote observations per (scenario, replica))."""
        res = self.run(params_or_theta, replicas=replicas, key=key,
                       protocol=protocol, leap=leap)
        return calibration_lib._eq1_coefficients(res)

    def presimulate(
        self,
        prior: "calibration_lib.PriorBox",
        key: torch.Tensor,
        n_per_scenario: int,
        *,
        protocol: str = "webdav",
        batch: int = 128,
        leap: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(theta, x_sim, scenario_id)`` tuples over the fleet's scenarios
        (:func:`repro_torch.core.calibration.presimulate_bank`)."""
        return calibration_lib.presimulate_bank(
            self, prior, key, n_per_scenario, protocol=protocol, batch=batch,
            leap=self.leap if leap is None else leap,
        )

    def summary_features(self) -> np.ndarray:
        """Per-scenario campaign summary features ``[N, F]``, the amortized
        calibration's context table."""
        return summary_features(self.bank)

    def calibrate(
        self,
        x_true,
        key: torch.Tensor,
        cfg: Optional["calibration_lib.CalibrationConfig"] = None,
        prior: Optional["calibration_lib.PriorBox"] = None,
        *,
        protocol: str = "webdav",
        batch: int = 128,
        amortized: bool = False,
    ):
        """Likelihood-free calibration of theta = (overhead, mu, sigma)
        against ``x_true``, presimulating over every scenario of the fleet
        (``cfg.n_presim`` tuples in all, scenario-major, leap as
        ``cfg.use_leap`` says), then training, MCMC and theta* as
        :func:`repro_torch.core.calibration.calibrate`. ``amortized=True``
        conditions the classifier on :meth:`summary_features` and returns
        an :class:`~repro_torch.core.calibration.AmortizedPosterior`.
        ``cfg.n_replicates > 1`` is ignored here, with a warning."""
        cfg = cfg if cfg is not None else calibration_lib.CalibrationConfig()
        if cfg.n_replicates > 1:
            calibration_lib.log.warning(
                "Fleet.calibrate draws single-realization tuples; "
                "cfg.n_replicates=%d is ignored on the banked path",
                cfg.n_replicates,
            )
        prior = prior if prior is not None else calibration_lib.PriorBox.paper()
        key, k_pre = prng.split(key.to(self.device), 2)
        n_per = max(1, -(-cfg.n_presim // self.n_scenarios))
        theta, x_sim, sid = self.presimulate(
            prior, k_pre, n_per, protocol=protocol,
            batch=min(batch, n_per), leap=cfg.use_leap,
        )
        return calibration_lib.calibrate(
            None, self.bank, x_true, key, cfg, prior, protocol=protocol,
            presim=(theta, x_sim, sid) if amortized else (theta, x_sim),
            amortized=amortized,
        )

    def validate(
        self,
        theta_star,
        x_true,
        key: torch.Tensor,
        *,
        n_sims: int = 64,
        protocol: str = "webdav",
        leap: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """Validation sweep under theta* (``[3]`` or per scenario ``[N,
        3]``) across every scenario
        (:func:`repro_torch.core.calibration.validate_bank`)."""
        return calibration_lib.validate_bank(
            self, theta_star, x_true, key, n_sims=n_sims, protocol=protocol,
            leap=self.leap if leap is None else leap,
        )
