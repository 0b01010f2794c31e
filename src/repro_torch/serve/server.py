"""``SimServer``: the synchronous in-process simulation service.

One server owns a set of warm :class:`~repro_torch.serve.slots.SlotBank`
banks (one per pad signature) on one device, a per-signature admission
queue, and the result store. ``submit`` compiles the request to a
single-scenario row and enqueues it; ``step`` runs one **overlapped**
scheduling round; ``drain`` steps until nothing is queued or resident.
Results come back per request the round their scenario finishes, not when
the whole batch drains.

A round is four phases, ordered so that the host never waits on work it
dispatched in the *same* round:

1. **ADMIT**: fill free slots from the native-signature queues, then a
   coalescing pass: a request whose native bank is cold (never built) or
   saturated is re-stacked up-tier into an existing wider bank whose
   signature dominates its pads (its rows are cut back to native shape at
   retire, bitwise by the inert-pad and prefix-stable RNG contracts). Every
   upload is staged in pinned memory and enqueued without a wait.
2. **DISPATCH**: every believed-live bank picks a rung of its window ladder
   from its residual-work estimates and launches one window step, then
   enqueues its post-step liveness / result snapshot into pinned host
   buffers behind a CUDA event. Nothing in this phase waits for the card.
3. **FETCH**: wait on the events of the snapshots dispatched *last* round:
   the round's only wait, on device work that has had a full round to run.
4. **RETIRE**: free every slot the fetched snapshots prove finished,
   cutting its rows out of the snapshot's host buffers (never the live
   carry). A finished row is found at most one round late; the extra window
   it sits through leaves its frozen carry bitwise as it is.

On the CPU the same phases run with the tensors taken directly and no
events: dispatch by device, with no backend knob.

Parity contract: a served result is **bitwise** the port's ``Fleet.run`` of
the same scenario with the same theta and keys: admissions are masked carry
restarts, empty slots and unused replica lanes are inert, window steps
freeze finished elements whatever the rung, and every parameter row comes
from the same row-local calibration mapper ``Fleet.run`` uses
(``tests/test_torch_serve.py`` holds it).

Left out of the reference's server: ``devices`` and the sharded slot bank
(ROADMAP A.9), and the ``REPRO_DEBUG`` sanitizers with the zero-retrace
guard (A.10: torch traces nothing, a capture budget would take its place).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import calibration as calibration_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import prng
from repro_torch.core.engine import DeviceLike, make_bank_params, resolve_device
from repro_torch.core.workload import bank_from_tables, compile_campaign
from repro_torch.serve.cache import (
    BankSlotCache,
    dominates,
    pad_signature,
    signature_volume,
)
from repro_torch.serve.request import RequestResult, SimRequest
from repro_torch.serve.slots import Admission, SlotBank

__all__ = ["ServeConfig", "SimServer"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Server policy.

    ``slots`` / ``replicas`` fix every slot bank's ``[S, R]`` shape.
    ``pad_floors`` and ``quantize`` define the pad-signature tiers requests
    route by (power-of-two brackets by default; ``quantize=False`` pins one
    fixed shape and rejects campaigns that do not fit).

    ``window`` is the base fused window a scheduling round; ``None``
    resolves once through the engine's default for the server's device,
    floored at 8 (the host pays a dispatch a window). ``rungs`` is each
    bank's window ladder; ``None`` derives the power-of-two set ``{W/4, W,
    4W}`` from the base window. Results are bitwise the same for every
    rung, so the rung choice is a cost knob only.

    ``coalesce`` enables up-tier routing: a request whose native-signature
    bank is cold or saturated may run in a wider bank whose signature
    dominates its pads, if the wide bank's pad volume is at most
    ``coalesce_ratio`` times the native volume. A window runs every pad
    element, so an up-tiered row costs up to ``coalesce_ratio`` times its
    native work.
    """

    slots: int = 8
    replicas: int = 1
    pad_floors: Tuple[int, int, int] = (8, 8, 8)
    quantize: bool = True
    window: Optional[int] = None
    rungs: Optional[Tuple[int, ...]] = None
    leap: bool = False
    warm_dir: Optional[str] = None
    coalesce: bool = True
    coalesce_ratio: float = 2.0


class _Pending(collections.namedtuple("_Pending", "admission submitted_at")):
    __slots__ = ()


class SimServer:
    """Continuous-batching simulation server (synchronous, in-process) on
    ``device`` (default ``cuda``; raises without one)."""

    def __init__(self, config: Optional[ServeConfig] = None, *, device: DeviceLike = None):
        self.config = config or ServeConfig()
        if self.config.slots < 1:
            raise ValueError(f"slots must be >= 1: {self.config.slots}")
        if self.config.replicas < 1:
            raise ValueError(f"replicas must be >= 1: {self.config.replicas}")
        self.device = resolve_device(device)
        if self.config.window is not None:
            self.window = max(1, int(self.config.window))
        else:
            self.window = max(
                8, engine_lib._resolve_window(None, self.config.leap, self.device)
            )
        if self.config.rungs is not None:
            self.rungs = tuple(sorted(set(int(r) for r in self.config.rungs)))
        else:
            self.rungs = tuple(
                sorted({max(1, self.window // 4), self.window, self.window * 4})
            )
        if any(r < 1 for r in self.rungs):
            raise ValueError(f"window rungs must be >= 1: {self.rungs}")
        self.cache = BankSlotCache(self.config.slots, warm_dir=self.config.warm_dir)
        self.banks: Dict[tuple, SlotBank] = {}
        self.queues: Dict[tuple, Deque[_Pending]] = {}
        self.results: Dict[int, RequestResult] = {}
        self._submitted_at: Dict[int, float] = {}
        self._admitted_at: Dict[int, float] = {}
        self._seen_rids: set = set()
        self._unreturned: List[RequestResult] = []
        self.rounds = 0
        self.coalesced = 0
        # the wall split of the overlapped rounds, accumulated
        self.wall_admit_s = 0.0
        self.wall_dispatch_s = 0.0
        self.wall_sync_s = 0.0
        self.wall_retire_s = 0.0

    # -- submission ---------------------------------------------------------

    def submit(self, req: SimRequest) -> int:
        """Compile and enqueue one request; returns its ``rid``.

        Compilation (campaign -> leg table -> single-row bank at the native
        signature, the row's params through the calibration mapper, its
        replica keys, and the residual-work estimate for the rung choice)
        runs here, on the host, so the scheduling rounds stay routing and
        device work.
        """
        if req.rid in self._seen_rids:
            raise ValueError(f"duplicate request id {req.rid}")
        if req.n_replicas > self.config.replicas:
            raise ValueError(
                f"request {req.rid} wants {req.n_replicas} replicas but the "
                f"server's slot banks carry replicas={self.config.replicas}; "
                "raise ServeConfig.replicas"
            )
        table = compile_campaign(req.grid, req.campaign)
        sig = pad_signature(
            table, floors=self.config.pad_floors, quantize=self.config.quantize
        )
        name = req.name if req.name is not None else f"request_{req.rid}"
        row_bank = bank_from_tables(
            [table], names=[name], pad_legs=sig[0], pad_procs=sig[1], pad_links=sig[2],
        )
        if req.theta is None:
            params = make_bank_params(row_bank, device="cpu")
        else:
            params = calibration_lib.make_theta_mapper(
                row_bank, req.protocol, missing_ok=True, device="cpu"
            )(torch.as_tensor(np.asarray(req.theta, np.float32)))
        if req.keys is not None:
            row_keys = np.asarray(req.keys, np.uint32)
        else:
            row_keys = prng.split(prng.PRNGKey(req.seed), req.n_replicas).numpy().astype(
                np.uint32)
        # unused replica lanes get zero keys but are inert (born done by the
        # per-lane enabled mask): they cost nothing and leave the retired
        # [n_replicas, ...] slice as it is
        keys = np.zeros((self.config.replicas, 2), np.uint32)
        keys[: req.n_replicas] = row_keys
        if self.config.leap:
            est = table.leap_event_estimate()
        else:
            est = table.max_ticks_upper_bound(bg_override_cap=0.0, slack=1.0)
        adm = Admission(
            request=req,
            row_bank=row_bank,
            keep_frac=params.keep_frac.numpy()[0],
            bg_mu=params.bg_mu.numpy()[0],
            bg_sigma=params.bg_sigma.numpy()[0],
            keys=keys,
            table=table,
            native_sig=sig,
            est_units=max(1, int(math.ceil(float(est)))),
        )
        self._seen_rids.add(req.rid)
        self.queues.setdefault(sig, collections.deque()).append(
            _Pending(adm, time.perf_counter())
        )
        return req.rid

    # -- routing ------------------------------------------------------------

    def _bank_for(self, sig: tuple, seed_bank) -> SlotBank:
        bank = self.banks.get(sig)
        if bank is None:
            template = self.cache.get_or_create(sig, seed_bank)
            bank = SlotBank(
                sig, template, self.config.replicas,
                window=self.window, rungs=self.rungs,
                leap=self.config.leap, device=self.device,
            )
            self.banks[sig] = bank
        return bank

    def _coalesce_target(
        self, sig: tuple, taken: Optional[Dict[tuple, int]] = None
    ) -> Optional[SlotBank]:
        """The cheapest existing bank a ``sig``-native request may run in
        up-tier: signature strictly wider, dominating every pad axis, pad
        volume within ``coalesce_ratio`` of native, and (when ``taken``, the
        slots already claimed this round, is given) a free slot beyond the
        claims. None when no such bank exists."""
        native_vol = signature_volume(sig)
        best = None
        for bsig, bank in self.banks.items():
            if tuple(bsig) == tuple(sig) or not dominates(bsig, sig):
                continue
            if signature_volume(bsig) > self.config.coalesce_ratio * native_vol:
                continue
            if taken is not None:
                free = len(bank.free_slots()) - taken.get(tuple(bsig), 0)
                if free <= 0:
                    continue
            if best is None or signature_volume(bsig) < signature_volume(best.signature):
                best = bank
        return best

    def _restack(self, adm: Admission, sig: tuple) -> Admission:
        """Re-stack an admission at a wider bank's pads: the row bank
        rebuilt from the compiled table at ``sig``, the param rows extended
        with the canonical inert fills (keep 1, mu = sigma = 0). The widened
        row is bitwise the native row on the native extent."""
        req = adm.request
        name = req.name if req.name is not None else f"request_{req.rid}"
        row_bank = bank_from_tables(
            [adm.table], names=[name], pad_legs=sig[0], pad_procs=sig[1], pad_links=sig[2],
        )
        keep = np.ones(sig[0], np.float32)
        keep[: adm.keep_frac.shape[0]] = adm.keep_frac
        bg_mu = np.zeros(sig[2], np.float32)
        bg_mu[: adm.bg_mu.shape[0]] = adm.bg_mu
        bg_sigma = np.zeros(sig[2], np.float32)
        bg_sigma[: adm.bg_sigma.shape[0]] = adm.bg_sigma
        return dataclasses.replace(
            adm, row_bank=row_bank, keep_frac=keep, bg_mu=bg_mu, bg_sigma=bg_sigma,
        )

    def _ensure_banks(self) -> int:
        """Create slot banks for queued signatures that have none, unless
        coalescing can host the queue in an existing wider bank (the cold
        native bank is then never built). Returns how many were created."""
        created = 0
        for sig, queue in list(self.queues.items()):
            if not queue or sig in self.banks:
                continue
            if self.config.coalesce and self._coalesce_target(sig) is not None:
                continue
            self._bank_for(sig, queue[0].admission.row_bank)
            created += 1
        return created

    # -- scheduling ---------------------------------------------------------

    def _pop_for(self, queue: Deque[_Pending], now: float) -> Admission:
        pending = queue.popleft()
        adm = pending.admission
        if adm.request.n_replicas > self.config.replicas:
            # submit() rejects oversized requests before queueing, so such
            # an entry was put in the queue from outside: fail it loudly
            # rather than let it cycle (admitted but never live would spin
            # drain)
            raise ValueError(
                f"request {adm.request.rid} asks for "
                f"{adm.request.n_replicas} replicas but the server "
                f"runs {self.config.replicas}; it can never be admitted"
            )
        rid = adm.request.rid
        self._submitted_at[rid] = pending.submitted_at
        self._admitted_at[rid] = now
        return adm

    def _admit_phase(self, now: float) -> None:
        """Native pass (every queue fills its own bank's free slots), then
        the coalescing pass: whatever is still queued (native bank cold or
        saturated) is re-stacked into a dominating wider bank with room,
        cheapest signature first."""
        for sig, bank in self.banks.items():
            queue = self.queues.get(sig)
            if not queue:
                continue
            entries = []
            for slot in bank.free_slots():
                if not queue:
                    break
                entries.append((slot, self._pop_for(queue, now)))
            if entries:
                bank.admit(entries)
        if not self.config.coalesce:
            return
        for sig, queue in self.queues.items():
            batches: Dict[tuple, List[Tuple[int, Admission]]] = {}
            taken: Dict[tuple, int] = {}
            while queue:
                target = self._coalesce_target(sig, taken)
                if target is None:
                    break
                tsig = tuple(target.signature)
                k = taken.get(tsig, 0)
                slot = target.free_slots()[k]
                taken[tsig] = k + 1
                adm = self._restack(self._pop_for(queue, now), tsig)
                batches.setdefault(tsig, []).append((slot, adm))
                self.coalesced += 1
            for tsig, entries in batches.items():
                self.banks[tsig].admit(entries)

    def _dispatch_phase(self) -> None:
        """One window step (and its snapshot's dispatch) on every bank
        believed live; nothing here waits for the card."""
        for bank in self.banks.values():
            if bank.any_believed_live():
                bank.step(bank.choose_rung())

    def _fetch_phase(self, pend) -> None:
        """Wait on last round's snapshot events (the round's only wait) and
        install the snapshots."""
        for bank, snap in pend:
            if snap.event is not None:
                snap.event.synchronize()
            bank.apply_snapshot(snap.version, snap.live.numpy(), snap.result)

    def _retire_phase(self, now: float) -> None:
        """Free every slot the fetched snapshots prove finished and store its
        result."""
        for sig, bank in self.banks.items():
            for s in bank.retirable_slots():
                native = tuple(bank.slot_native[s] or sig)
                done_req, rows, windows, _ticks = bank.retire(s)
                res = RequestResult(
                    rid=done_req.rid,
                    name=done_req.name or f"request_{done_req.rid}",
                    result=rows,
                    n_replicas=done_req.n_replicas,
                    signature=native,
                    slot=s,
                    submitted_at=self._submitted_at.pop(done_req.rid),
                    admitted_at=self._admitted_at.pop(done_req.rid),
                    finished_at=now,
                    windows=windows,
                )
                self.results[done_req.rid] = res
                self._unreturned.append(res)

    def _round(self, now: float) -> bool:
        """One overlapped scheduling round: admit -> dispatch -> fetch ->
        retire (see the module docstring). Returns True while any bank
        still holds resident work."""
        t0 = time.perf_counter()
        # the snapshots dispatched last round: the fetch waits on these,
        # never on the steps dispatched below
        pend = []
        for bank in self.banks.values():
            snap = bank.pending_snapshot()
            if snap is not None:
                pend.append((bank, snap))
        self._admit_phase(now)
        t1 = time.perf_counter()
        self._dispatch_phase()
        t2 = time.perf_counter()
        self._fetch_phase(pend)
        t3 = time.perf_counter()
        self._retire_phase(now)
        t4 = time.perf_counter()
        self.wall_admit_s += t1 - t0
        self.wall_dispatch_s += t2 - t1
        self.wall_sync_s += t3 - t2
        self.wall_retire_s += t4 - t3
        return any(b.occupied for b in self.banks.values())

    def step(self) -> bool:
        """One scheduling round over every slot bank. Returns True while any
        request is still queued or resident."""
        now = time.perf_counter()
        self._ensure_banks()
        busy = self._round(now)
        self.rounds += 1
        return busy or any(self.queues.values())

    def poll(self, rid: int) -> Optional[RequestResult]:
        """The finished result for ``rid``, or ``None`` while it is still
        queued or running (non-destructive)."""
        if rid not in self._seen_rids:
            raise KeyError(f"unknown request id {rid}")
        return self.results.get(rid)

    def _progress_snapshot(self) -> tuple:
        """Monotone progress counters: every legitimate busy round advances
        at least one (admission bumps ``admitted``, resident work bumps
        ``windows_total``, completion bumps ``retired`` / ``results``)."""
        return (
            sum(b.admitted for b in self.banks.values()),
            sum(b.retired for b in self.banks.values()),
            sum(b.windows_total for b in self.banks.values()),
            len(self.results),
        )

    def drain(self, *, max_rounds: int = 1_000_000) -> List[RequestResult]:
        """Step until every submitted request has finished; returns the
        results completed since the last ``drain`` in completion order (each
        exactly once).

        Liveness guard: a busy round that advances **no** progress counter
        (no admission, no window stepped, no retirement) means some queued
        request can never be admitted (e.g. a queue entry that bypassed
        :meth:`submit`'s checks). Such a stall raises at once, naming the
        stuck request ids, instead of spinning to ``max_rounds``."""
        rounds = 0
        before = self._progress_snapshot()
        while self.step():
            after = self._progress_snapshot()
            if after == before:
                stuck = [p.admission.request.rid for q in self.queues.values() for p in q]
                raise RuntimeError(
                    "drain stalled: a scheduling round reported busy but "
                    "admitted, stepped, and retired nothing; queued "
                    f"request ids {stuck} can never be admitted"
                )
            before = after
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"drain did not converge within {max_rounds} scheduling "
                    "rounds: a request can neither finish nor admit"
                )
        out = self._unreturned
        self._unreturned = []
        return out

    # -- observability ------------------------------------------------------

    def metrics(self) -> dict:
        """Serving metrics: global counters, the wall split of the
        overlapped rounds, and per-signature slot-bank occupancy, rung
        histogram and coalescing. ``mesh_devices`` is 0: the port's server
        runs on one device (ROADMAP A.9)."""
        return {
            "rounds": self.rounds,
            "submitted": len(self._seen_rids),
            "completed": len(self.results),
            "queued": sum(len(q) for q in self.queues.values()),
            "resident": sum(b.occupied for b in self.banks.values()),
            "window": self.window,
            "rungs": list(self.rungs),
            "coalesced": self.coalesced,
            "slots": self.config.slots,
            "replicas": self.config.replicas,
            "wall_split_s": {
                "admit": self.wall_admit_s,
                "dispatch": self.wall_dispatch_s,
                "sync": self.wall_sync_s,
                "retire": self.wall_retire_s,
            },
            "mesh_devices": 0,
            "cache": {
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "warm_loads": self.cache.warm_loads,
            },
            "slot_banks": {
                "x".join(str(d) for d in sig): bank.metrics()
                for sig, bank in self.banks.items()
            },
        }
