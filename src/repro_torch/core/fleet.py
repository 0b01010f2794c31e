"""``repro_torch.Fleet``: compile a scenario fleet, simulate, persist and
stream it.

The port's façade over :func:`workload.compile_bank` and
:func:`engine.simulate_bank`, mirroring the reference's ``repro.Fleet``:

- **compile**: :meth:`Fleet.from_pairs` / :meth:`Fleet.from_scenarios`
  compile a bank (bucketed with ``n_buckets > 1``) and memoize it in the
  fleet-level compile cache; :meth:`Fleet.from_table` lifts one compiled
  campaign;
- **simulate**: :meth:`Fleet.run` with the reference's replica-key
  schedule (a calibration theta ``[3]`` or per scenario ``[N, 3]`` maps
  through the calibration mapper); :meth:`Fleet.stream` pipelines an
  iterator of pairs through chunk banks at the fleet's pads;
- **persist**: :meth:`Fleet.save` / :meth:`Fleet.load` and
  :meth:`Fleet.save_checkpoint` / :meth:`Fleet.load_checkpoint` in the
  reference's on-disk format 1, so each package loads the other's
  directories;
- **calibrate**: :meth:`Fleet.coefficients`, :meth:`Fleet.presimulate`,
  :meth:`Fleet.calibrate`, :meth:`Fleet.validate` through the banked path
  of :mod:`repro_torch.core.calibration`.

A fleet runs on ``device`` (default ``cuda``).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any, Callable, Dict, Hashable, Iterable, Iterator, List, NamedTuple, Optional, Sequence,
    Tuple, Union,
)

import numpy as np
import torch

from repro_torch.core import calibration as calibration_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import prng
from repro_torch.core import workload
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
    BankBucket,
    BucketedBank,
    Campaign,
    LegTable,
    ScenarioBank,
    bank_from_tables,
    compile_bank,
    compile_campaign,
    pad_bank_scenarios,
    subset_bank,
    summary_features,
)

__all__ = ["Fleet", "StreamChunk", "clear_compile_cache"]

PairsLike = Sequence[Tuple[Grid, Campaign]]
TicksLike = Union[None, int, Sequence[int], np.ndarray]
ParamsLike = Union[None, SimParams, torch.Tensor, Sequence[float], np.ndarray,
                   Callable[[ScenarioBank], SimParams]]

# every ScenarioBank field persisted and loaded as a dense array
_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(ScenarioBank)
    if f.name not in ("protocol_names", "names", "tables")
)

# The fleet-level compile cache: compiled banks are immutable and costly
# (a Python loop over every campaign), so façades built from one recipe
# share the bank, and with it its device specs. Values are banks (or
# ``(keepalive, bank)`` for identity-keyed entries), never fleets: run
# options stay per façade. FIFO-bounded, so a process that keeps minting
# recipes does not keep every bank. Every access holds the lock: the
# stream's prefetch thread compiles through the same cache, and the
# eviction in _cache_put is a compound operation.
_COMPILE_CACHE_MAX = 64
_compile_cache: dict = {}
_COMPILE_CACHE_LOCK = threading.RLock()


def _cache_get(key: Hashable) -> Any:
    with _COMPILE_CACHE_LOCK:
        return _compile_cache.get(key)


def _cache_put(key: Hashable, value: Any) -> None:
    with _COMPILE_CACHE_LOCK:
        _compile_cache.pop(key, None)  # re-insert at the back
        _compile_cache[key] = value
        while len(_compile_cache) > _COMPILE_CACHE_MAX:
            _compile_cache.pop(next(iter(_compile_cache)))


def clear_compile_cache() -> None:
    """Drop every memoized compiled bank."""
    with _COMPILE_CACHE_LOCK:
        _compile_cache.clear()


def _hashable_ticks(max_ticks) -> Union[None, int, Tuple[int, ...]]:
    """A ``max_ticks`` spec (None / int / sequence) as a cache key."""
    if max_ticks is None:
        return None
    if np.ndim(max_ticks) == 0:
        return int(max_ticks)
    return tuple(int(m) for m in max_ticks)


class StreamChunk(NamedTuple):
    """One chunk of :meth:`Fleet.stream`: its compiled bank, its result
    (sliced to the chunk's real scenarios) and their names."""

    bank: ScenarioBank
    result: SimResult
    names: List[str]


class Fleet:
    """A compiled scenario fleet with its run policy (lowering, leap,
    window, device).

    Construct with :meth:`from_pairs`, :meth:`from_scenarios`,
    :meth:`from_table`, :meth:`load`, or wrap a compiled bank:
    ``Fleet(bank)``.
    """

    def __init__(
        self,
        bank: ScenarioBank,
        *,
        lowering: Optional[str] = None,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        if not isinstance(bank, ScenarioBank):
            raise TypeError(f"Fleet wraps a compiled ScenarioBank, got {type(bank)!r}")
        engine_lib._resolve_lowering(lowering)
        self.bank = bank
        self.lowering = lowering
        self.leap = leap
        self.window = window
        self.device = resolve_device(device)
        self._base_params: Optional[SimParams] = None
        self._mappers: Dict[str, Callable[[Any], SimParams]] = {}

    # -- compile ------------------------------------------------------------

    @classmethod
    def from_pairs(
        cls,
        pairs: Union[PairsLike, Callable[[], PairsLike]],
        *,
        max_ticks: TicksLike = None,
        n_buckets: int = 1,
        bucket_packing: str = "cost",
        bucket_slack: Optional[float] = None,
        bucket_counts: Optional[Sequence[int]] = None,
        pad_floors: Optional[Tuple[int, int, int]] = None,
        pad_multiple: int = 1,
        bucket_pad_floors: Optional[Sequence[Tuple[int, int, int]]] = None,
        cache_key: Optional[Any] = None,
        lowering: Optional[str] = None,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Compile ``(grid, campaign)`` pairs into a fleet.

        ``pad_floors = (legs, procs, links)`` are the global pad floors
        (:func:`workload.compile_bank`'s ``pad_*``); ``n_buckets``,
        ``bucket_packing``, ``bucket_slack``, ``bucket_counts`` and
        ``bucket_pad_floors`` shape a bucketed bank (the fleet's ``leap``
        picks the packing cost model: event estimates, or tick windows).
        A hashable ``cache_key`` memoizes the bank in the compile cache; it
        must identify the pair set, and every compile knob folds into the
        cache key, so one ``cache_key`` with other knobs compiles anew.
        ``pairs`` may be a callable returning the pairs, called only on a
        cache miss."""
        slack = (workload._DEFAULT_BUCKET_SLACK if bucket_slack is None
                 else float(bucket_slack))
        key = None if cache_key is None else (
            "pairs", cache_key, _hashable_ticks(max_ticks), n_buckets, bucket_packing,
            slack, tuple(bucket_counts) if bucket_counts is not None else None,
            bool(leap),  # leap selects the packing cost model
            tuple(pad_floors) if pad_floors is not None else None, pad_multiple,
            tuple(map(tuple, bucket_pad_floors)) if bucket_pad_floors is not None else None,
        )
        bank = _cache_get(key) if key is not None else None
        if bank is None:
            pl, pp, pk = pad_floors if pad_floors is not None else (None, None, None)
            bank = compile_bank(
                list(pairs() if callable(pairs) else pairs),
                max_ticks=max_ticks, pad_legs=pl, pad_procs=pp, pad_links=pk,
                pad_multiple=pad_multiple, n_buckets=n_buckets,
                bucket_packing=bucket_packing, bucket_slack=slack,
                bucket_cost_leap=leap, bucket_counts=bucket_counts,
                bucket_pad_floors=bucket_pad_floors,
            )
            if key is not None:
                _cache_put(key, bank)
        return cls(bank, lowering=lowering, leap=leap, window=window, device=device)

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
        bucket_packing: str = "cost",
        bucket_slack: Optional[float] = None,
        bucket_counts: Optional[Sequence[int]] = None,
        pad_floors: Optional[Tuple[int, int, int]] = None,
        pad_multiple: int = 1,
        bucket_pad_floors: Optional[Sequence[Tuple[int, int, int]]] = None,
        cache: bool = True,
        lowering: Optional[str] = None,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Sample ``n`` scenarios from the family registry (seeds ``seed``
        to ``seed + n - 1``) and compile them. The recipe (families, n,
        seed, scale) identifies the pair set, so with ``cache`` it is the
        :meth:`from_pairs` ``cache_key``: two calls with one recipe and the
        same knobs share the bank."""
        recipe = ("scenarios", tuple(families) if families is not None else None, n, seed,
                  scale)
        return cls.from_pairs(
            lambda: sample_scenarios(families, n, seed, scale=scale),
            max_ticks=max_ticks, n_buckets=n_buckets, bucket_packing=bucket_packing,
            bucket_slack=bucket_slack, bucket_counts=bucket_counts, pad_floors=pad_floors,
            pad_multiple=pad_multiple, bucket_pad_floors=bucket_pad_floors,
            cache_key=recipe if cache else None, lowering=lowering, leap=leap,
            window=window, device=device,
        )

    @classmethod
    def from_table(
        cls,
        table: LegTable,
        *,
        name: str = "table0",
        max_ticks: TicksLike = None,
        lowering: Optional[str] = None,
        leap: bool = False,
        window: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "Fleet":
        """Lift one compiled :class:`LegTable` into a single-scenario fleet
        (pads equal the table's own shape, so nothing is padded). This is
        how the scheduler runs population fitness as one banked batch:
        ``B`` ``enabled`` masks become per-replica params of the one
        scenario. Memoized per table identity (the cache entry keeps the
        table alive, so its id is not reused while cached)."""
        key = ("table", id(table), _hashable_ticks(max_ticks), name)
        hit = _cache_get(key)
        if hit is not None and hit[0] is table:
            bank = hit[1]
        else:
            bank = bank_from_tables([table], [name], max_ticks=max_ticks)
            _cache_put(key, (table, bank))
        return cls(bank, lowering=lowering, leap=leap, window=window, device=device)

    # -- introspection ------------------------------------------------------

    @property
    def n_scenarios(self) -> int:
        return self.bank.n_scenarios

    @property
    def names(self) -> List[str]:
        return list(self.bank.names)

    @property
    def pad_legs(self) -> int:
        return self.bank.pad_legs

    @property
    def pad_procs(self) -> int:
        return self.bank.pad_procs

    @property
    def pad_links(self) -> int:
        return self.bank.pad_links

    @property
    def pads(self) -> Tuple[int, int, int]:
        """The global ``(legs, procs, links)`` pad shape: what every chunk
        of :meth:`stream` compiles to, and ``pad_floors`` for fleets that
        should share it."""
        return (self.pad_legs, self.pad_procs, self.pad_links)

    @property
    def resident(self) -> "residency_lib.ResidentBank":
        """The bank's device residency on the fleet's device
        (:class:`~repro_torch.core.residency.ResidentBank`, memoized per
        bank and device): the spec :meth:`run` uses, as a stepped surface."""
        from repro_torch.core import residency as residency_lib

        return residency_lib.ResidentBank.of(self.bank, self.device)

    @property
    def n_buckets(self) -> int:
        return self.bank.n_buckets if isinstance(self.bank, BucketedBank) else 1

    @property
    def bucket_pad_floors(self) -> Optional[List[Tuple[int, int, int]]]:
        """Per-bucket pad shapes, reusable as ``bucket_pad_floors``."""
        if not isinstance(self.bank, BucketedBank):
            return None
        return [(b.bank.pad_legs, b.bank.pad_procs, b.bank.pad_links) for b in self.bank.buckets]

    @property
    def bucket_scenario_counts(self) -> Optional[Tuple[int, ...]]:
        """Unpadded member counts per bucket in packed order, reusable as
        ``bucket_counts`` to pin another fleet of this size to this plan."""
        if not isinstance(self.bank, BucketedBank):
            return None
        return self.bank.bucket_scenario_counts

    def __repr__(self) -> str:
        return (
            f"Fleet({type(self.bank).__name__}: {self.n_scenarios} scenarios, "
            f"pads={self.pads}, buckets={self.n_buckets}, lowering={self.lowering!r}, "
            f"leap={self.leap}, window={self.window}, device={self.device})"
        )

    # -- params -------------------------------------------------------------

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

    def _resolve_params(self, params_or_theta: ParamsLike, protocol: str,
                        bank: Optional[ScenarioBank] = None) -> SimParams:
        """``None`` -> the bank's params; ``SimParams`` -> as given; a
        callable -> ``params_or_theta(bank)``; a ``[3]`` theta or a
        per-scenario ``[N, 3]`` theta -> the calibration mapper. ``bank``
        (a stream's chunk bank) takes the fleet's bank's place."""
        target = self.bank if bank is None else bank
        if params_or_theta is None:
            if bank is None:
                return self.params()
            return make_bank_params(target, device=self.device)
        if isinstance(params_or_theta, SimParams):
            return params_or_theta
        if callable(params_or_theta):
            return params_or_theta(target)
        theta = torch.as_tensor(params_or_theta, dtype=torch.float32)
        if tuple(theta.shape) not in ((3,), (target.n_scenarios, 3)):
            raise TypeError(
                "params_or_theta must be SimParams, a theta [3] vector, a "
                f"per-scenario theta [{target.n_scenarios}, 3] matrix, a "
                f"callable bank -> SimParams, or None; got shape {tuple(theta.shape)}"
            )
        if bank is None:
            return self.theta_mapper(protocol)(theta.to(self.device))
        # a chunk bank unions only its own protocols: without the calibrated
        # one its legs get no overhead, as inside the fleet-wide namespace
        return calibration_lib.make_theta_mapper(
            target, protocol, missing_ok=True, device=self.device)(theta.to(self.device))

    # -- simulate -----------------------------------------------------------

    def _keys(self, key: Optional[torch.Tensor], n: int, r: int) -> torch.Tensor:
        key = prng.PRNGKey(0, self.device) if key is None else key.to(self.device)
        return prng.split(key, n * r).reshape(n, r, 2)

    def run(
        self,
        params_or_theta: ParamsLike = None,
        *,
        replicas: Optional[int] = None,
        key: Optional[torch.Tensor] = None,
        keys: Optional[torch.Tensor] = None,
        protocol: str = "webdav",
        lowering: Optional[str] = None,
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
        ``lowering``, ``leap`` and ``window`` default to the fleet's; results
        come back in scenario order, bucketed or not.
        """
        params = self._resolve_params(params_or_theta, protocol)
        n = self.n_scenarios
        if keys is None:
            keys = self._keys(key, n, 1 if replicas is None else int(replicas))
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
            lowering=self.lowering if lowering is None else lowering,
        )

    def stream(
        self,
        pairs: Iterable[Tuple[Grid, Campaign]],
        *,
        chunk: Optional[int] = None,
        params_or_theta: ParamsLike = None,
        replicas: int = 1,
        key: Optional[torch.Tensor] = None,
        protocol: str = "webdav",
        max_ticks: TicksLike = None,
        lowering: Optional[str] = None,
        leap: Optional[bool] = None,
        window: Optional[int] = None,
        prefetch: int = 0,
    ) -> Iterator[StreamChunk]:
        """Pipeline an iterator of ``(grid, campaign)`` pairs through chunk
        banks of ``chunk`` pairs (default: this fleet's scenario count),
        each compiled monolithically to this fleet's pads. A scenario too
        large for the pads raises; the last, partial chunk is padded by
        repeating its last pair and sliced back to its real scenarios.

        ``max_ticks`` caps each streamed scenario (``None``: its safe upper
        bound). Key schedule: per chunk, ``key, sub = prng.split(key)``,
        then the chunk's keys are ``prng.split(sub, chunk * replicas)
        .reshape(chunk, replicas, 2)``, so any chunk can be reproduced with
        :func:`engine.simulate_bank` alone. ``params_or_theta`` is built per
        chunk bank: ``None``, a theta ``[3]``, or a callable ``bank ->
        SimParams``; a fixed :class:`SimParams` is refused (its rows belong
        to other scenarios).

        ``prefetch=k`` (k >= 1) compiles and uploads up to ``k`` next chunk
        banks on a worker thread while the current chunk runs through
        :func:`engine.simulate_bank_stepped`, which returns to the host
        between windows. Results and keys are those of ``prefetch=0``
        bitwise.
        """
        if isinstance(params_or_theta, SimParams):
            raise TypeError(
                "stream rebuilds params per chunk bank: pass None, a theta "
                "[3] vector, or a callable bank -> SimParams instead of a "
                "fixed SimParams"
            )
        chunk = int(chunk) if chunk is not None else self.n_scenarios
        if chunk <= 0:
            raise ValueError(f"chunk must be positive: {chunk}")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0: {prefetch}")
        return self._stream_chunks(pairs, chunk, params_or_theta, replicas, key, protocol,
                                   max_ticks, lowering, leap, window, int(prefetch))

    def _build_chunk(self, block: Sequence[Tuple[Grid, Campaign]], chunk: int,
                     max_ticks: TicksLike) -> Tuple[ScenarioBank, int]:
        """Compile one block of the stream into a chunk bank at the fleet's
        pads and upload its spec (on the worker thread under ``prefetch``).
        The worker's uploads and table builds go to the same (legacy
        default) CUDA stream as the consumer's windows: safe, and what
        overlaps is host work (compilation, table builds), not copies."""
        real = len(block)
        tables = [compile_campaign(g, c) for g, c in block]
        names = [c.name for _, c in block]
        if real < chunk:  # the tail chunk: its last table repeated, same shape
            tables += [tables[-1]] * (chunk - real)
            names += [names[-1]] * (chunk - real)
        cbank = bank_from_tables(tables, names, max_ticks=max_ticks, pad_legs=self.pad_legs,
                                 pad_procs=self.pad_procs, pad_links=self.pad_links)
        if (cbank.pad_legs, cbank.pad_procs, cbank.pad_links) != self.pads:
            raise ValueError(
                f"stream chunk outgrew the fleet pads {self.pads} -> "
                f"{(cbank.pad_legs, cbank.pad_procs, cbank.pad_links)}; "
                "compile the fleet with pad_floors covering the stream"
            )
        engine_lib.bank_spec(cbank, self.device)
        return cbank, real

    def _stream_chunks(self, pairs, chunk, params_or_theta, replicas, key, protocol,
                       max_ticks, lowering, leap, window, prefetch) -> Iterator[StreamChunk]:
        key = prng.PRNGKey(0, self.device) if key is None else key.to(self.device)
        it = iter(pairs)
        leap = self.leap if leap is None else leap
        lowering = self.lowering if lowering is None else lowering
        window = self.window if window is None else window
        # the stepped loop returns to the host between windows, which gives
        # the prefetch thread its turns; it is the banked lowering's loop
        use_stepped = prefetch > 0 and engine_lib._resolve_lowering(lowering) == "banked"

        def ready(cbank: ScenarioBank, real: int) -> StreamChunk:
            nonlocal key
            key, sub = prng.split(key, 2)
            keys = prng.split(sub, chunk * replicas).reshape(chunk, replicas, 2)
            cparams = self._resolve_params(params_or_theta, protocol, bank=cbank)
            if use_stepped:
                res = engine_lib.simulate_bank_stepped(cbank, cparams, keys, leap=leap,
                                                       window=window, device=self.device)
            else:
                res = simulate_bank(cbank, cparams, keys, leap=leap, window=window,
                                    device=self.device, lowering=lowering)
            if real < chunk:
                res = SimResult(*(f[:real] for f in res))
            return StreamChunk(bank=cbank, result=res, names=list(cbank.names[:real]))

        if prefetch <= 0:
            while True:
                block = list(itertools.islice(it, chunk))
                if not block:
                    return
                yield ready(*self._build_chunk(block, chunk, max_ticks))

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fleet-stream-prefetch")
        try:
            pending = collections.deque()
            for _ in range(prefetch + 1):
                block = list(itertools.islice(it, chunk))
                if not block:
                    break
                pending.append(pool.submit(self._build_chunk, block, chunk, max_ticks))
            while pending:
                cbank, real = pending.popleft().result()
                # top the pipeline up before simulating, so the compile of
                # chunk i + prefetch overlaps the windows of chunk i
                block = list(itertools.islice(it, chunk))
                if block:
                    pending.append(pool.submit(self._build_chunk, block, chunk, max_ticks))
                yield ready(cbank, real)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        """Persist the compiled bank to ``path/`` as ``bank.npz`` (every
        stacked array) and ``meta.json`` (names, protocol namespace, pads,
        bucket structure, run options), the reference's format 1. The source
        :class:`LegTable` objects are not saved: a loaded fleet simulates
        bitwise but has no ``scenario_table``. ``run_opts`` holds the
        reference's keys: ``lowering``, ``leap``, ``backend`` (always
        ``null``), ``window`` and ``resolved_window``, what ``window=None``
        resolves to on this fleet's device, which a load replays."""
        os.makedirs(path, exist_ok=True)
        bank = self.bank
        arrays = {name: np.asarray(getattr(bank, name)) for name in _ARRAY_FIELDS}
        meta = {
            "format": 1,
            "protocol_names": list(bank.protocol_names),
            "names": list(bank.names),
            "pads": list(self.pads),
            "run_opts": {
                "lowering": self.lowering,
                "leap": self.leap,
                "backend": None,
                "window": self.window,
                "resolved_window": (
                    self.window if self.window is not None
                    else engine_lib.default_tick_window(self.leap, self.device)
                ),
            },
            "bucketed": isinstance(bank, BucketedBank),
        }
        if isinstance(bank, BucketedBank):
            arrays["bucket_of"] = np.asarray(bank.bucket_of)
            arrays["slot_of"] = np.asarray(bank.slot_of)
            meta["packing"] = bank.packing
            meta["buckets"] = [
                {
                    "scenario_ids": [int(i) for i in b.scenario_ids],
                    "pad_legs": b.bank.pad_legs,
                    "pad_procs": b.bank.pad_procs,
                    "pad_links": b.bank.pad_links,
                    "scenarios": b.bank.n_scenarios,
                    "cost": float(b.cost),
                    "cost_share": float(b.cost_share),
                }
                for b in bank.buckets
            ]
        np.savez_compressed(os.path.join(path, "bank.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return path

    @classmethod
    def load(cls, path: str, **run_opts: Any) -> "Fleet":
        """Rebuild a fleet saved by :meth:`save` (or by the reference's
        ``Fleet.save``). A bucketed bank is restored bucket by bucket, each
        sub-bank sliced out of the saved arrays
        (:func:`workload.subset_bank`) and padded to its saved scenario
        count. ``run_opts`` (``lowering``, ``leap``, ``window``, ``device``)
        override the saved options; ``backend`` is ignored. A saved
        ``window=None`` replays the saved ``resolved_window``. A directory
        that cannot be read raises ``ValueError``."""
        meta_path = os.path.join(path, "meta.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot read fleet metadata {meta_path!r}: {e}") from e
        if not isinstance(meta, dict) or meta.get("format") != 1:
            fmt = meta.get("format") if isinstance(meta, dict) else None
            raise ValueError(f"unknown fleet save format: {fmt!r}")
        bank_path = os.path.join(path, "bank.npz")
        try:
            with np.load(bank_path) as z:
                arrays = {k: z[k] for k in z.files}
            base = {name: arrays[name] for name in _ARRAY_FIELDS}
            bank: ScenarioBank = ScenarioBank(
                **base, protocol_names=list(meta["protocol_names"]),
                names=list(meta["names"]), tables=[],
            )
            if meta["bucketed"]:
                bank = _load_buckets(bank, meta, arrays)
        except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"cannot load the fleet saved under {path!r}: {e}; bank.npz or "
                "meta.json is truncated, corrupted or from another format"
            ) from e
        opts = dict(meta.get("run_opts") or {})
        resolved = opts.pop("resolved_window", None)
        opts.pop("backend", None)
        run_opts.pop("backend", None)
        opts.update(run_opts)
        if opts.get("window") is None and resolved is not None:
            opts["window"] = int(resolved)
        return cls(bank, **opts)

    def save_checkpoint(self, path: str, ckpt: "engine_lib.BankCheckpoint", *,
                        include_fleet: bool = True) -> str:
        """Persist a :class:`~repro_torch.core.engine.BankCheckpoint` to
        ``path/`` as ``carry.npz`` and ``checkpoint.json`` (the reference's
        format 1; the carry's key as ``uint32``, as the reference stores
        it); with ``include_fleet`` the directory also receives
        :meth:`save`'s files, so one directory restores the fleet and its
        run."""
        os.makedirs(path, exist_ok=True)
        carry = {f: np.asarray(a) for f, a in zip(ckpt.carry._fields, ckpt.carry)}
        carry["key"] = carry["key"].astype(np.uint32)
        np.savez_compressed(os.path.join(path, "carry.npz"), **carry)
        with open(os.path.join(path, "checkpoint.json"), "w") as f:
            json.dump({"format": 1, "windows_done": int(ckpt.windows_done),
                       "window": int(ckpt.window)}, f, indent=2)
        if include_fleet:
            self.save(path)
        return path

    @staticmethod
    def load_checkpoint(path: str) -> "engine_lib.BankCheckpoint":
        """A carry snapshot saved by :meth:`save_checkpoint` (either
        package's), its key as the port's ``int64``; pass it as
        ``simulate_bank_stepped(..., resume=ckpt)`` with the same bank,
        params and window to continue the run bitwise."""
        meta_path = os.path.join(path, "checkpoint.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"cannot read checkpoint metadata {meta_path!r}: {e}; the "
                "checkpoint directory is missing or its checkpoint.json is "
                "truncated or corrupted"
            ) from e
        if not isinstance(meta, dict) or meta.get("format") != 1:
            fmt = meta.get("format") if isinstance(meta, dict) else None
            raise ValueError(f"unknown checkpoint format: {fmt!r}")
        carry_path = os.path.join(path, "carry.npz")
        try:
            with np.load(carry_path) as z:
                carry = engine_lib._Carry(*(z[f] for f in engine_lib._Carry._fields))
            windows_done, window = int(meta["windows_done"]), int(meta["window"])
        except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"cannot load checkpoint carry {carry_path!r}: {e}; the npz is "
                "truncated or corrupted or lacks carry fields "
                f"{list(engine_lib._Carry._fields)}"
            ) from e
        carry = carry._replace(key=carry.key.astype(np.int64))
        return engine_lib.BankCheckpoint(windows_done=windows_done, window=window, carry=carry)

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


def _load_buckets(mono: ScenarioBank, meta: dict, arrays: dict) -> BucketedBank:
    """The :class:`BucketedBank` of a saved bucketed fleet: each bucket
    sliced out of the saved monolithic arrays at its saved pads, padded to
    its saved (shard-padded) scenario count."""
    buckets = []
    for info in meta["buckets"]:
        ids = np.asarray(info["scenario_ids"], np.int32)
        sub = subset_bank(mono, ids, pad_legs=info["pad_legs"], pad_procs=info["pad_procs"],
                          pad_links=info["pad_links"])
        padded = int(info.get("scenarios", len(ids)))
        if padded > len(ids):
            sub = pad_bank_scenarios(sub, count=padded)
        # saves from before cost packing carry no cost (still format 1)
        buckets.append(BankBucket(scenario_ids=ids, bank=sub,
                                  cost=float(info.get("cost", 0.0)),
                                  cost_share=float(info.get("cost_share", 0.0))))
    return BucketedBank(
        **{f.name: getattr(mono, f.name) for f in dataclasses.fields(ScenarioBank)},
        bucket_of=arrays["bucket_of"], slot_of=arrays["slot_of"], buckets=buckets,
        packing=str(meta.get("packing", "count")),
    )
