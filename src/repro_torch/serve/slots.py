"""A slot bank: one resident, mutable, fixed-shape bank of serving slots.

``slots`` scenario rows x ``replicas`` RNG replicas, resident on the
server's device as a :class:`~repro_torch.core.residency.ResidentBank`,
advanced window by window through the engine's stepped loop. Finished rows
freeze (their carry is done: further windows leave it bitwise as it is),
free rows are inert shard-pad scenarios (never live), and admission
overwrites a row's spec, params and keys in the host mirrors, uploads them,
and restarts exactly the admitted rows inside the running carry
(``ResidentBank.admit``).

Scheduling is **overlapped**, not lockstep. The bank never waits on its own
liveness: each window step is followed at once by a snapshot of the
post-step carry (``ResidentBank.snapshot``), copied on the card into
pinned host buffers with ``non_blocking=True`` behind a recorded
``torch.cuda.Event``; the server waits on *last* round's events, one round
later. Host-side ``live_mask`` is therefore the *believed* liveness, at
most one round stale, and retirement reads rows from the fetched snapshot
(fresh host buffers, allocated anew for every snapshot, so no later copy
writes them), so retiring never waits on a step in flight. Retiring one
round late is still bitwise exact because a finished row's carry is frozen.
On the CPU the same code takes the snapshot's tensors directly, with no
events: dispatch by device, as ``kernels.ops`` does.

Every upload of an admission (spec rows, params, keys, the admission mask)
goes through :func:`repro_torch.kernels.ref.upload`: staged into pinned
memory at once (the numpy mirrors may change right after) and enqueued
with ``non_blocking=True``, so no phase of a round but the fetch waits for
the card.

Instead of one fixed window, the bank holds a small power-of-two **rung
ladder** (e.g. ``{W/4, W, 4W}``); results are bitwise the same for every
window size, so the rung is a cost knob only. ``choose_rung`` sizes the
round from the residual-work estimates carried by each admission. The
constructor runs the admission merge, one window per rung and a snapshot
on the all-inert carry, as the reference's warm-up does.

Unused replica lanes of an admitted row (``n_replicas < replicas``) are
**inert**: a per-lane ``enabled`` mask makes them born done, so they never
tick, never draw, and never hold the row live. A row admitted up-tier
(signature coalescing) remembers its native signature; ``retire`` cuts the
leg axis back to the native pad, bitwise the native-pads run by the
inert-pad and prefix-stable RNG contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import DeviceLike, SimParams, SimResult, resolve_device
from repro_torch.core.residency import ResidentBank
from repro_torch.core.workload import LegTable, ScenarioBank
from repro_torch.kernels import ref
from repro_torch.serve.request import SimRequest

__all__ = ["SlotBank", "Admission"]


@dataclasses.dataclass
class Admission:
    """One request ready to enter a slot: its single-row bank (at the
    *routed* bank's pads), its row params, and its ``[R, 2]`` replica keys
    (already padded to the slot bank's replica count). ``native_sig`` is
    the request's own quantized signature (what ``retire`` cuts back to
    when the row was coalesced up-tier), ``table`` the compiled leg table
    (kept so that a re-route can re-stack the row at a wider bank's pads),
    and ``est_units`` the residual-work estimate, expected engine iterations
    (ticks, or event leaps under ``leap``), for the rung choice."""

    request: SimRequest
    row_bank: ScenarioBank
    keep_frac: np.ndarray  # [T] f32
    bg_mu: np.ndarray  # [L] f32
    bg_sigma: np.ndarray  # [L] f32
    keys: np.ndarray  # [R, 2] uint32
    table: Optional[LegTable] = None
    native_sig: Optional[Tuple[int, int, int]] = None
    est_units: int = 1


def _owned_copy(bank: ScenarioBank) -> ScenarioBank:
    """A deep array copy of ``bank`` that a mutable ResidentBank may own
    (the cached template must survive this slot bank's row writes)."""
    fields = {}
    for f in dataclasses.fields(ScenarioBank):
        v = getattr(bank, f.name)
        if isinstance(v, np.ndarray):
            v = np.array(v, copy=True)
        elif isinstance(v, list):
            v = list(v)
        fields[f.name] = v
    return ScenarioBank(**fields)


class _Snapshot(NamedTuple):
    """A dispatched snapshot: the carry version it was taken at, ``[S]`` row
    liveness and the bank :class:`SimResult` as host tensors, and the CUDA
    event recorded after their copies were enqueued (``None`` on the CPU,
    where the tensors are the snapshot itself). The host tensors are valid
    once the event has completed."""

    version: int
    live: torch.Tensor
    result: SimResult
    event: Optional["torch.cuda.Event"]


def _to_pinned(x: torch.Tensor) -> torch.Tensor:
    """An enqueued copy of a device tensor into a fresh pinned host buffer
    (no wait; read it after the stream's next event)."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)


class SlotBank:
    """``slots`` warm serving rows at one pad signature, on ``device``
    (default ``cuda``)."""

    def __init__(
        self,
        signature: Tuple[int, int, int],
        template: ScenarioBank,
        replicas: int,
        *,
        window: int,
        rungs: Optional[Sequence[int]] = None,
        leap: bool = False,
        device: DeviceLike = None,
    ) -> None:
        self.signature = signature
        self.n_slots = template.n_scenarios
        self.replicas = int(replicas)
        self.window = int(window)
        self.rungs: Tuple[int, ...] = tuple(
            sorted(set(int(r) for r in (rungs or [window])))
        )
        if any(r < 1 for r in self.rungs):
            raise ValueError(f"window rungs must be >= 1: {self.rungs}")
        self.leap = bool(leap)
        self.device = resolve_device(device)

        self.resident = ResidentBank(_owned_copy(template), mutable=True, device=self.device)
        T = template.pad_legs
        L = template.pad_links
        S = self.n_slots
        R = self.replicas
        # host params mirrors with the inert-row fills (keep 1, mu = sigma =
        # 0). ``enabled`` is per *lane* [S, R, T]: admission switches on
        # exactly the request's n_replicas lanes, the rest stay born done.
        self._keep = np.ones((S, T), np.float32)
        self._bg_mu = np.zeros((S, L), np.float32)
        self._bg_sigma = np.zeros((S, L), np.float32)
        self._keys = np.zeros((S, R, 2), np.uint32)
        self._enabled = np.zeros((S, R, T), bool)
        self._params_dev, self._keys_dev = self._upload_params()

        self.slot_req: List[Optional[SimRequest]] = [None] * S
        self.slot_native: List[Optional[Tuple[int, int, int]]] = [None] * S
        self.slot_windows = [0] * S  # windows since the row was admitted
        self.slot_est = [0] * S  # residual-work estimate at admission
        self.slot_units = [0] * S  # window units stepped while resident
        # believed row liveness: True from admission until a snapshot at or
        # after the admission's version says otherwise
        self.live_mask = np.zeros(S, bool)
        self._admit_version = np.zeros(S, np.int64)
        self._version = 0
        # observability
        self.windows_total = 0
        self.occupied_window_sum = 0  # sum over windows of occupied slots
        self.admitted = 0
        self.retired = 0
        self.realized_ticks = 0  # sum of retired rows' realized tick counts
        self.rung_windows: Dict[int, int] = {r: 0 for r in self.rungs}
        self.coalesced_in = 0  # rows admitted with a narrower native sig
        # EMA of realized ticks across this bank's retired rows: the static
        # per-request estimates are upper bounds that overshoot severalfold,
        # which would pin the ladder to its top rung. 0 = no retire yet.
        self.ema_ticks = 0.0

        # ---- warm-up: the admission merge, every rung, a snapshot ---------
        self.carry = self.resident.init_carry(self._params_dev, self._keys_dev)
        self.carry = self.resident.admit(
            self._params_dev, self._keys_dev, self.carry, np.zeros(S, bool)
        )
        for rung in self.rungs:
            self.carry = self.resident.window_step(
                self._params_dev, self.carry, leap=self.leap, window=rung, draw=self._draw()
            )
        # latest dispatched snapshot / latest fetched one, the fetched side as
        # (carry version, [S] host liveness, host bank result)
        self._snap = self._dispatch_snapshot()
        if self._snap.event is not None:
            self._snap.event.synchronize()
        self._seen = (0, np.zeros(S, bool), self._snap.result)

    # -- params -------------------------------------------------------------

    def _upload_params(self) -> Tuple[SimParams, torch.Tensor]:
        """The params and keys mirrors on the bank's device, each by
        :func:`ref.upload` (staged at once, enqueued without a wait)."""
        up = lambda a: ref.upload(a, self.device)
        params = SimParams(
            keep_frac=up(self._keep),
            bg_mu=up(self._bg_mu),
            bg_sigma=up(self._bg_sigma),
            enabled=up(self._enabled),
        )
        return params, up(self._keys.astype(np.int64))

    def _draw(self) -> bool:
        """Whether any row's ``bg_sigma`` is positive, from the host mirror
        (the window step then reads nothing from the device)."""
        return bool((self._bg_sigma > 0).any())

    def _dispatch_snapshot(self) -> _Snapshot:
        """The post-step snapshot of the current carry: on the card, its
        copies into pinned host buffers enqueued and an event recorded
        behind them; on the CPU, the snapshot's own tensors."""
        live, result = self.resident.snapshot(self.carry)
        if self.device.type != "cuda":
            return _Snapshot(self._version, live, result, None)
        live = _to_pinned(live)
        result = SimResult(*(_to_pinned(f) for f in result))
        event = torch.cuda.Event()
        event.record()
        return _Snapshot(self._version, live, result, event)

    # -- scheduling surface -------------------------------------------------

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is None]

    def any_believed_live(self) -> bool:
        """Whether this round should dispatch a window step: some resident
        row was live as of the last fetched snapshot (or was admitted after
        it and is optimistically live)."""
        return bool(self.live_mask.any())

    def live_rows(self) -> np.ndarray:
        """Host ``[S]`` row liveness of the *current* carry.

        Debug surface only: it waits for every step in flight. The
        scheduler uses the snapshot pipeline (``pending_snapshot`` /
        ``apply_snapshot``) instead.
        """
        return torch.any(self.resident.live(self.carry), dim=-1).cpu().numpy()

    def admit(self, entries: Sequence[Tuple[int, "Admission"]]) -> None:
        """Admit ``(slot, admission)`` pairs in one masked merge.

        Writes every admitted row into the host mirrors, uploads the spec,
        params and keys, and restarts exactly the admitted rows inside the
        carry; rows in flight pass through bitwise. Unused replica lanes are
        disabled (born done); admitted rows are believed live until a
        snapshot at or after this carry version reports them finished.
        """
        if not entries:
            return
        mask = np.zeros(self.n_slots, bool)
        for slot, adm in entries:
            if self.slot_req[slot] is not None:
                raise ValueError(f"slot {slot} is occupied")
            mask[slot] = True
            self.resident.write_rows([slot], adm.row_bank)
            self._keep[slot] = adm.keep_frac
            self._bg_mu[slot] = adm.bg_mu
            self._bg_sigma[slot] = adm.bg_sigma
            self._keys[slot] = adm.keys
            n_rep = adm.request.n_replicas
            self._enabled[slot] = False
            self._enabled[slot, :n_rep, :] = True
            self.slot_req[slot] = adm.request
            native = adm.native_sig or self.signature
            self.slot_native[slot] = native
            if tuple(native) != tuple(self.signature):
                self.coalesced_in += 1
            self.slot_windows[slot] = 0
            self.slot_est[slot] = max(1, int(adm.est_units))
            self.slot_units[slot] = 0
        self._params_dev, self._keys_dev = self._upload_params()
        self.carry = self.resident.admit(self._params_dev, self._keys_dev, self.carry, mask)
        self._version += 1
        self._admit_version[mask] = self._version
        self.live_mask |= mask
        self.admitted += int(mask.sum())

    def choose_rung(self) -> int:
        """This round's window from the residual-work estimates: the largest
        rung that does not overshoot the *nearest* believed-live completion.
        Slot turnover is the throughput lever: a window runs all its ticks
        over every lane, frozen rows included, so a wide window past a
        completion burns bank-wide work while the finished row waits to
        retire. When every resident run is long, wide rungs amortize the
        host's dispatch.

        Once this bank has retired a row, each estimate is capped at 1.1x
        the realized-ticks EMA (overshooting a completion costs a wide
        window, undershooting only a base-window step). A row past its
        (capped) estimate claims the base window."""
        cap = int(self.ema_ticks * 1.1) if self.ema_ticks else None
        horizon = None
        for s, req in enumerate(self.slot_req):
            if req is None or not self.live_mask[s]:
                continue
            est = self.slot_est[s] if cap is None else min(self.slot_est[s], cap)
            left = est - self.slot_units[s]
            if left <= 0:
                left = self.window
            horizon = left if horizon is None else min(horizon, left)
        if horizon is None:
            return self.rungs[0]
        for rung in reversed(self.rungs):
            if rung <= horizon:
                return rung
        return self.rungs[0]

    def step(self, rung: Optional[int] = None) -> None:
        """One window step over the whole slot bank, followed at once by the
        post-step snapshot's dispatch (nothing waits for the card: the
        server fetches snapshots a round later)."""
        rung = self.window if rung is None else int(rung)
        self.carry = self.resident.window_step(
            self._params_dev, self.carry, leap=self.leap, window=rung, draw=self._draw()
        )
        self._version += 1
        self.windows_total += 1
        self.rung_windows[rung] = self.rung_windows.get(rung, 0) + 1
        self.occupied_window_sum += self.occupied
        for s, r in enumerate(self.slot_req):
            if r is not None:
                self.slot_windows[s] += 1
                self.slot_units[s] += rung
        self._snap = self._dispatch_snapshot()

    def pending_snapshot(self) -> Optional[_Snapshot]:
        """The latest dispatched but unfetched snapshot, or None when it is
        already applied. The server waits on these across all banks in its
        fetch phase."""
        return self._snap if self._snap.version > self._seen[0] else None

    def apply_snapshot(self, version: int, live: np.ndarray, result: SimResult) -> None:
        """Install a fetched snapshot: update the believed liveness of every
        row it covers (admitted at or before its version; a row admitted
        later stays optimistically live until a newer snapshot)."""
        if version <= self._seen[0]:
            return
        self._seen = (int(version), np.array(live, bool), result)
        for s in range(self.n_slots):
            if self._admit_version[s] <= version:
                self.live_mask[s] = bool(live[s]) and self.slot_req[s] is not None

    def retirable_slots(self) -> List[int]:
        """Slots whose request is finished *as of the fetched snapshot*:
        occupied, covered by the snapshot's version, and not live in it."""
        version, live, _ = self._seen
        return [
            s
            for s in range(self.n_slots)
            if self.slot_req[s] is not None
            and self._admit_version[s] <= version
            and not live[s]
        ]

    def retire(
        self, slot: int, result: Optional[SimResult] = None
    ) -> Tuple[SimRequest, SimResult, int, int]:
        """Take the finished request out of ``slot`` and free it.

        Returns ``(request, result_rows, windows_resident, realized_ticks)``:
        ``result_rows`` is the request's bitwise ``[n_replicas, ...]`` slice
        of the *fetched snapshot's* host result (copied out of it), its leg
        axis cut back to the request's native pad (a no-op unless the row
        was coalesced up-tier). The row froze before that snapshot was
        taken, so the one-round-old view is final. The freed row keeps its
        frozen carry (all done: every further window over it is a no-op)
        until the next admission overwrites it. ``result`` must be this
        bank's fetched snapshot result when given.
        """
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        full = self._seen[2] if result is None else result
        r = req.n_replicas
        native_legs = (self.slot_native[slot] or self.signature)[0]

        def cut(a: torch.Tensor) -> torch.Tensor:
            a = a[slot, :r]
            return (a[:, :native_legs] if a.dim() == 2 else a).clone()

        rows = SimResult(*(cut(f) for f in full))
        ticks = int(rows.ticks.max())
        windows = self.slot_windows[slot]
        self.slot_req[slot] = None
        self.slot_native[slot] = None
        self.slot_windows[slot] = 0
        self.slot_est[slot] = 0
        self.slot_units[slot] = 0
        self.live_mask[slot] = False
        self.retired += 1
        self.realized_ticks += ticks
        self.ema_ticks = (
            float(ticks) if not self.ema_ticks else 0.7 * self.ema_ticks + 0.3 * ticks
        )
        return req, rows, windows, ticks

    # -- observability ------------------------------------------------------

    def metrics(self) -> dict:
        denom = max(1, self.windows_total * self.n_slots)
        return {
            "slots": self.n_slots,
            "replicas": self.replicas,
            "window": self.window,
            "rungs": list(self.rungs),
            "rung_windows": {str(r): c for r, c in sorted(self.rung_windows.items())},
            "windows_total": self.windows_total,
            "admitted": self.admitted,
            "retired": self.retired,
            "coalesced_in": self.coalesced_in,
            "occupancy_mean": self.occupied_window_sum / max(1, self.windows_total),
            "idle_window_fraction": 1.0 - self.occupied_window_sum / denom,
            "realized_ticks": self.realized_ticks,
        }
