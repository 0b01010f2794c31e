"""Pad signature -> warm slot-bank template cache.

Every slot bank is born from an **all-inert template**: ``slots`` scenario
rows of shard-pad filler (``workload.pad_bank_scenarios``: zero-size legs,
``max_ticks=0``, never live) at one pad signature ``(pad_legs, pad_procs,
pad_links)``. Requests whose campaigns quantize to the same signature share
one template shape; admission overwrites rows of a mutable
:class:`~repro_torch.core.residency.ResidentBank` copy without changing it.

The cache can persist each template through ``Fleet.save`` /
``Fleet.load`` (``warm_dir/slot_TxPxL/``, the reference's format 1, so
either package reads the other's store): a restarted server then skips the
stack-and-pad construction for signatures it has served before. Loaded
templates are made inert again through the same canonical
``pad_bank_scenarios`` fills whatever the artifact holds: a warm start
never revives stale scenario rows into a fresh carry.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from repro_torch.core.workload import (
    LegTable,
    ScenarioBank,
    _resolve_pads,
    pad_bank_scenarios,
    subset_bank,
)

__all__ = [
    "BankSlotCache",
    "dominates",
    "pad_signature",
    "quantize_axis",
    "signature_volume",
]

Signature = Tuple[int, int, int]


def dominates(wide: Signature, narrow: Signature) -> bool:
    """Whether a bank at signature ``wide`` can host a request whose native
    signature is ``narrow``: every pad axis at least as large. Up-tier
    coalescing is bitwise-safe because padded legs, processes and links are
    inert (they add exactly zero to every sum) and a key's draws are
    prefix-stable across link-pad widths (the partitionable threefry), so
    the wide row's values on the narrow extent equal the narrow run's."""
    return all(w >= n for w, n in zip(wide, narrow))


def signature_volume(sig: Signature) -> int:
    """Pad volume ``legs * procs * links``: the coalescing router's waste
    metric. Among the warm banks dominating a request the smallest volume
    wins, and up-tiers wider than ``ServeConfig.coalesce_ratio`` times the
    native volume are refused."""
    t, p, l = sig
    return int(t) * int(p) * int(l)


def quantize_axis(n: int, floor: int) -> int:
    """Smallest power-of-two tier >= max(n, floor): it keeps the set of
    slot-bank shapes small while every campaign fits its tier. The floor
    is rounded up to a power of two first, so every tier is a power of two
    whatever the floor (``quantize_axis(13, 12) == 16``)."""
    tier = 1
    while tier < max(1, int(floor)):
        tier *= 2
    while tier < n:
        tier *= 2
    return tier


def pad_signature(
    table: LegTable,
    *,
    floors: Tuple[int, int, int] = (8, 8, 8),
    quantize: bool = True,
) -> Signature:
    """The slot-bank routing key of a compiled campaign.

    ``quantize=True`` brackets each axis to a power-of-two tier at least
    ``floors``; ``quantize=False`` pins every request to the one ``floors``
    shape and raises when a campaign does not fit (the fixed pads of
    ``Fleet.stream``).
    """
    t, p, l = _resolve_pads([table], None, None, None, 1)
    if not quantize:
        ft, fp, fl = floors
        if t > ft or p > fp or l > fl:
            raise ValueError(
                f"campaign needs pads {(t, p, l)} but the server is pinned "
                f"to fixed pad_floors {floors} (quantize=False); raise the "
                "floors or enable quantized signature tiers"
            )
        return (int(ft), int(fp), int(fl))
    return (
        quantize_axis(t, floors[0]),
        quantize_axis(p, floors[1]),
        quantize_axis(l, floors[2]),
    )


def _inert_template(bank: ScenarioBank, slots: int) -> ScenarioBank:
    """``slots`` all-inert scenario rows at ``bank``'s pads, built from the
    canonical shard-pad fills (append pads, slice them back out: bitwise
    ``pad_bank_scenarios``' rows by construction)."""
    n = bank.n_scenarios
    # pad rows carry no source table: strip the tables so the subset below
    # does not slice them
    stripped = dataclasses.replace(bank, tables=[])
    padded = pad_bank_scenarios(stripped, count=n + slots)
    return subset_bank(padded, list(range(n, n + slots)))


class BankSlotCache:
    """In-process signature -> template cache with an optional on-disk warm
    store (``Fleet.save`` format, one ``slot_TxPxL/`` directory a
    signature). Templates are host data."""

    def __init__(self, slots: int, *, warm_dir: Optional[str] = None) -> None:
        if slots < 1:
            raise ValueError(f"slots must be >= 1: {slots}")
        self.slots = int(slots)
        self.warm_dir = warm_dir
        self._templates: Dict[Signature, ScenarioBank] = {}
        self.hits = 0
        self.misses = 0
        self.warm_loads = 0

    def _warm_path(self, sig: Signature) -> Optional[str]:
        if self.warm_dir is None:
            return None
        t, p, l = sig
        return os.path.join(self.warm_dir, f"slot_{t}x{p}x{l}")

    def get_or_create(self, sig: Signature, seed_bank: ScenarioBank) -> ScenarioBank:
        """The all-inert ``slots``-row template for ``sig``: from the
        in-process cache, the warm store, or derived from ``seed_bank`` (any
        bank stacked at ``sig``'s pads, such as the first routed request's
        one-row bank; then written to the warm store)."""
        template = self._templates.get(sig)
        if template is not None:
            self.hits += 1
            return template
        self.misses += 1

        from repro_torch.core.fleet import Fleet  # fleet sits above this module

        path = self._warm_path(sig)
        if path is not None and os.path.isdir(path):
            loaded = Fleet.load(path, device="cpu").bank
            if (
                (loaded.pad_legs, loaded.pad_procs, loaded.pad_links) != sig
                or loaded.n_scenarios < 1
            ):
                raise ValueError(
                    f"warm slot artifact {path!r} carries pads "
                    f"{(loaded.pad_legs, loaded.pad_procs, loaded.pad_links)}"
                    f" x {loaded.n_scenarios} scenarios, expected signature "
                    f"{sig}; delete or regenerate the warm store"
                )
            # never trust persisted rows to be inert: rebuild them from the
            # canonical pad fills at the artifact's shapes
            template = _inert_template(
                subset_bank(dataclasses.replace(loaded, tables=[]), [0]), self.slots
            )
            self.warm_loads += 1
        else:
            if (seed_bank.pad_legs, seed_bank.pad_procs, seed_bank.pad_links) != sig:
                raise ValueError(
                    f"seed bank pads "
                    f"{(seed_bank.pad_legs, seed_bank.pad_procs, seed_bank.pad_links)} "
                    f"do not match the requested signature {sig}"
                )
            template = _inert_template(seed_bank, self.slots)
            if path is not None:
                Fleet(template, device="cpu").save(path)

        self._templates[sig] = template
        return template
