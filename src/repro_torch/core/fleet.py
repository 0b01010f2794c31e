"""``repro_torch.Fleet``: compile a scenario fleet and simulate it.

The port's façade over :func:`workload.compile_bank` and
:func:`engine.simulate_bank`, mirroring the reference's ``repro.Fleet``:
:meth:`Fleet.from_pairs` / :meth:`Fleet.from_scenarios` compile a bank,
:meth:`Fleet.params` builds its parameters and :meth:`Fleet.run` simulates
it with the reference's replica-key schedule. A fleet runs on ``device``
(default ``cuda``). Calibration front-ends, ``stream``, ``save``/``load``,
checkpoints and the compile cache are not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
from repro_torch.core.workload import BucketedBank, Campaign, ScenarioBank, compile_bank

__all__ = ["Fleet"]

PairsLike = Sequence[Tuple[Grid, Campaign]]
TicksLike = Union[None, int, Sequence[int], np.ndarray]


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

    def run(
        self,
        params: Optional[SimParams] = None,
        *,
        replicas: Optional[int] = None,
        key: Optional[torch.Tensor] = None,
        keys: Optional[torch.Tensor] = None,
        leap: Optional[bool] = None,
        bucketed: bool = True,
        window: Optional[int] = None,
    ) -> SimResult:
        """Simulate every scenario x ``replicas`` stochastic replicas.

        ``params`` is ``None`` (the bank's own) or a :class:`SimParams`
        (calibration thetas are not ported yet). Replica keys are split from ``key``
        (default ``prng.PRNGKey(0)``) into ``[N, R, 2]`` exactly as the
        reference's ``Fleet.run`` splits them, unless explicit ``keys`` are
        given (the replica count then comes from the keys).
        """
        params = self.params() if params is None else params
        if not isinstance(params, SimParams):
            raise TypeError(
                f"params must be SimParams or None, got {type(params)!r} "
                "(calibration thetas are not ported yet)"
            )
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
