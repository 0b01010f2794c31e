"""Bank residency: a compiled bank's device buffers and its stepped loop,
apart from ``Fleet``.

:func:`engine.bank_spec` memoizes a bank's uploaded :class:`SimSpec` on the
bank, and only :func:`engine.simulate_bank` touches it. A serving loop needs
buffers that outlive one run: stepped window by window, with new scenario
rows admitted into a running carry. :class:`ResidentBank` owns them and
exposes the banked engine's host-driven surface:

- ``spec``: the device spec (for an immutable resident, ``bank_spec``'s own
  memo, so a ``Fleet.run`` over the same bank shares its buffers);
- ``init_carry`` / ``window_step`` / ``live`` / ``result``: the window loop
  of :func:`engine.simulate_bank_stepped`, as methods;
- ``admit``: restart a masked set of rows inside a running carry, every
  other row bitwise as it was (:func:`engine._admit_bank_rows`);
- ``snapshot``: ``([S] row liveness, SimResult)`` that later steps leave
  as it is (:func:`engine._bank_snapshot`);
- ``write_rows``: for ``mutable=True`` residents, overwrite whole scenario
  rows of the host bank; the spec (and its index tables) is rebuilt from
  the new rows at its next use.

``Fleet.resident`` returns the memoized immutable resident of the fleet's
bank on the fleet's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import DeviceLike, SimParams, SimResult, SimSpec
from repro_torch.core.workload import ScenarioBank

__all__ = ["ResidentBank"]


class ResidentBank:
    """A compiled bank's device residency and stepped execution state on
    ``device`` (default ``cuda``).

    ``mutable=False`` (default): a read-only view of an immutable compiled
    bank whose spec is ``engine.bank_spec``'s memo. ``mutable=True``: the
    resident owns the bank's host arrays and may overwrite scenario rows
    (:meth:`write_rows`); the caller hands over a bank no one else holds.
    """

    def __init__(self, bank: ScenarioBank, *, mutable: bool = False,
                 device: DeviceLike = None) -> None:
        if not isinstance(bank, ScenarioBank):
            raise TypeError(f"ResidentBank wraps a compiled ScenarioBank, got {type(bank)!r}")
        self.bank = bank
        self.mutable = mutable
        self.device = engine_lib.resolve_device(device)
        self._spec: Optional[SimSpec] = None

    @classmethod
    def of(cls, bank: ScenarioBank, device: DeviceLike = None) -> "ResidentBank":
        """The memoized immutable resident of ``bank`` on ``device`` (one per
        bank and device, kept on the bank as its spec memo is)."""
        dev = engine_lib.resolve_device(device)
        cache = bank.__dict__.setdefault("_torch_resident_cache", {})
        resident = cache.get(str(dev))
        if resident is None:
            resident = cls(bank, device=dev)
            cache[str(dev)] = resident
        return resident

    @property
    def n_scenarios(self) -> int:
        return self.bank.n_scenarios

    @property
    def pads(self) -> tuple:
        return (self.bank.pad_legs, self.bank.pad_procs, self.bank.pad_links)

    @property
    def names(self) -> list:
        return list(self.bank.names)

    @property
    def spec(self) -> SimSpec:
        """The device spec: ``bank_spec``'s memo for an immutable resident;
        for a mutable one, uploaded anew after each :meth:`write_rows`."""
        if not self.mutable:
            return engine_lib.bank_spec(self.bank, self.device)
        if self._spec is None:
            self._spec = engine_lib._bank_spec_uncached(self.bank, self.device)
        return self._spec

    def write_rows(self, ids: Sequence[int], src: ScenarioBank) -> None:
        """Overwrite scenario rows ``ids`` with the rows of ``src`` (in
        order) in the host bank. ``src`` holds exactly ``len(ids)`` scenarios
        at this bank's pads. The device spec, the rows' index tables with
        it, is rebuilt at its next use, and every spec memoized on the bank
        is dropped."""
        if not self.mutable:
            raise ValueError(
                "write_rows on an immutable ResidentBank: build one with "
                "mutable=True (and a bank no one else holds) to write rows"
            )
        ids = [int(i) for i in ids]
        if src.n_scenarios != len(ids):
            raise ValueError(
                f"write_rows got {len(ids)} target rows but src carries "
                f"{src.n_scenarios} scenarios"
            )
        if (src.pad_legs, src.pad_procs, src.pad_links) != self.pads:
            raise ValueError(
                f"src pads {(src.pad_legs, src.pad_procs, src.pad_links)} "
                f"differ from resident pads {self.pads}; re-stack the source "
                "rows at the resident's pads (bank_from_tables with explicit "
                "pad_legs/pad_procs/pad_links)"
            )
        for f in dataclasses.fields(ScenarioBank):
            dst = getattr(self.bank, f.name, None)
            if not isinstance(dst, np.ndarray):
                continue
            rows = np.asarray(getattr(src, f.name))
            for k, i in enumerate(ids):
                dst[i] = rows[k]
        for k, i in enumerate(ids):
            self.bank.names[i] = src.names[k]
        self._spec = None
        for memo in ("_torch_spec_cache", "_torch_fold_cache"):
            self.bank.__dict__.pop(memo, None)

    def init_carry(self, params: SimParams, keys: torch.Tensor) -> engine_lib._Carry:
        """A fresh ``[S, R, ...]`` carry on the resident's device (the keys
        copied, so the caller's buffer stays its own)."""
        return engine_lib._banked_init_carry(self.spec, params, keys.to(self.device).clone())

    def window_step(self, params: SimParams, carry: engine_lib._Carry, *,
                    leap: bool = False, window: int = 1) -> engine_lib._Carry:
        """One window of ``window`` ticks (event leaps under ``leap``); the
        carry is rebound to the step's new tensors."""
        spec = self.spec
        draw = bool(torch.any(params.bg_sigma > 0))
        carry = engine_lib._bank_window_body(spec, params, leap, int(window), draw, carry)
        engine_lib.STATS["windows"] += 1
        return carry

    def admit(self, params: SimParams, keys: torch.Tensor, carry: engine_lib._Carry,
              mask) -> engine_lib._Carry:
        """Restart the rows ``mask`` selects from the current spec, params
        and keys; every other row passes through bitwise
        (:func:`engine._admit_bank_rows`)."""
        mask = torch.as_tensor(np.asarray(mask, bool)).to(self.device)
        return engine_lib._admit_bank_rows(self.spec, params, keys.to(self.device), carry, mask)

    def snapshot(self, carry: engine_lib._Carry):
        """``([S] row liveness, bank SimResult)``, holding no buffer of the
        carry (:func:`engine._bank_snapshot`)."""
        return engine_lib._bank_snapshot(self.spec, carry)

    def live(self, carry: engine_lib._Carry) -> torch.Tensor:
        """Per-element ``[S, R]`` liveness (the loop's condition)."""
        return engine_lib._banked_live(self.spec, carry)

    def result(self, carry: engine_lib._Carry) -> SimResult:
        """The bank-shaped :class:`SimResult` of a carry."""
        return engine_lib._banked_result(self.spec, carry)
