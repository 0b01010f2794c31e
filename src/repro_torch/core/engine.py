"""Banked GDAPS tick engine in PyTorch.

The port of the reference package's banked lowering
(``repro.core.engine``): a compiled scenario bank runs as one ``[S, R, ...]``
carry advanced by fused windows of ``K`` ticks (``K`` event leaps under
``leap``), each window one call of :func:`ops.grid_tick_bank_fused` — one
fused-kernel launch on the card in tick mode. The loop over windows runs on
the host and stops when no (scenario, replica) element is alive; results are
bitwise the same for every ``K`` (the alive freeze is inside the window).

Only the monolithic bank runs in this port so far: bucketed dispatch,
replica folding and the stepped (checkpointed) loop are open ROADMAP items.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.workload import BucketedBank, ScenarioBank
from repro_torch.kernels import ops, ref

__all__ = [
    "SimSpec",
    "SimParams",
    "SimResult",
    "resolve_device",
    "INDEX_TABLE_FIELDS",
    "with_index_tables",
    "bank_spec",
    "make_bank_params",
    "default_tick_window",
    "simulate_bank",
    "STATS",
]

#: Host-side counters of the banked loop: windows run since the last reset.
STATS = {"windows": 0}


class SimSpec(NamedTuple):
    """Device tensors describing a stacked bank of compiled campaigns: every
    field has a leading ``[N]`` scenario dim, ``max_ticks`` is per scenario
    and ``leg_valid`` masks the padding (padded legs are born done). The
    last three fields are the one-hot incidences as the kernels read them
    (``ref.bank_index_tables``), filled by :func:`with_index_tables`."""

    size_mb: torch.Tensor  # [N, T] f32
    release: torch.Tensor  # [N, T] i32
    dep: torch.Tensor  # [N, T] i32 (-1 = none)
    profile: torch.Tensor  # [N, T] i32 ProfileTag
    protocol_id: torch.Tensor  # [N, T] i32
    leg_proc: torch.Tensor  # [N, T, P] f32 one-hot
    proc_link: torch.Tensor  # [N, P, L] f32 one-hot
    leg_link: torch.Tensor  # [N, T, L] f32 one-hot
    bandwidth: torch.Tensor  # [N, L] f32 MB/tick
    bg_period: torch.Tensor  # [N, L] i32
    max_ticks: torch.Tensor  # [N] i32
    leg_valid: Optional[torch.Tensor] = None  # [N, T] bool
    proc_of_leg: Optional[torch.Tensor] = None  # [N, T] i32
    link_of_leg: Optional[torch.Tensor] = None  # [N, T] i32
    link_of_proc: Optional[torch.Tensor] = None  # [N, P] i32

    @property
    def index_tables(self):
        return (self.proc_of_leg, self.link_of_leg, self.link_of_proc)

    @property
    def n_legs(self) -> int:
        return self.size_mb.shape[-1]

    @property
    def n_links(self) -> int:
        return self.bandwidth.shape[-1]


class SimParams(NamedTuple):
    """Runtime parameters: per-leg keep fraction and per-link background-load
    moments, bank-wide ``[N, X]`` or per replica ``[N, R, X]``; ``enabled``
    masks legs out of the campaign (born done)."""

    keep_frac: torch.Tensor  # [N, T] f32 = 1 - overhead per leg
    bg_mu: torch.Tensor  # [N, L] f32
    bg_sigma: torch.Tensor  # [N, L] f32
    enabled: Optional[torch.Tensor] = None  # [N, T] bool (None = all enabled)


class SimResult(NamedTuple):
    """Per-leg observation record (the paper's (T, S, ConTh, ConPr) tuples),
    ``[N, R, T]`` per field and ``[N, R]`` for ``ticks``."""

    transfer_time: torch.Tensor  # f32 ticks (active duration)
    size_mb: torch.Tensor  # f32
    conth_mb: torch.Tensor  # f32 traffic of sibling threads during window
    conpr_mb: torch.Tensor  # f32 traffic of other campaign procs on the link
    done: torch.Tensor  # bool
    ticks: torch.Tensor  # i32 total ticks simulated
    profile: torch.Tensor  # i32
    start_tick: torch.Tensor  # f32 first active tick per leg


class _Carry(NamedTuple):
    t: torch.Tensor
    remaining: torch.Tensor
    done: torch.Tensor
    started: torch.Tensor
    t_start: torch.Tensor
    t_end: torch.Tensor
    conth: torch.Tensor
    conpr: torch.Tensor
    bg: torch.Tensor
    key: torch.Tensor


DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for a CUDA device without one raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


#: The :class:`SimSpec` fields that :func:`with_index_tables` derives.
INDEX_TABLE_FIELDS = ("proc_of_leg", "link_of_leg", "link_of_proc")


def with_index_tables(spec: SimSpec) -> SimSpec:
    """``spec`` with its index tables derived from its incidences, unless it
    already carries them."""
    if spec.proc_of_leg is not None:
        return spec
    tables = ref.bank_index_tables(spec.leg_proc, spec.proc_link, spec.leg_link)
    return spec._replace(**dict(zip(INDEX_TABLE_FIELDS, tables)))


def bank_spec(bank: ScenarioBank, device: DeviceLike = None) -> SimSpec:
    """The stacked ``[N, ...]`` SimSpec of a compiled bank on ``device``,
    memoized per device on the bank (compiled banks are immutable)."""
    dev = resolve_device(device)
    cache = bank.__dict__.setdefault("_torch_spec_cache", {})
    spec = cache.get(str(dev))
    if spec is None:
        t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        spec = with_index_tables(SimSpec(
            size_mb=t(bank.size_mb), release=t(bank.release), dep=t(bank.dep),
            profile=t(bank.profile), protocol_id=t(bank.protocol_id),
            leg_proc=t(bank.leg_proc), proc_link=t(bank.proc_link),
            leg_link=t(bank.leg_link), bandwidth=t(bank.bandwidth),
            bg_period=t(bank.bg_period), max_ticks=t(bank.max_ticks),
            leg_valid=t(bank.leg_valid),
        ))
        cache[str(dev)] = spec
    return spec


def make_bank_params(
    bank: ScenarioBank,
    *,
    overhead: Optional[float] = None,
    bg_mu: Optional[float] = None,
    bg_sigma: Optional[float] = None,
    protocol: Optional[str] = None,
    device: DeviceLike = None,
) -> SimParams:
    """Bank-wide :class:`SimParams` (``[N, T]`` keep, ``[N, L]`` moments),
    optionally overriding the overhead of one protocol (or of every leg) and
    the background moments of every real link."""
    dev = resolve_device(device)
    keep = bank.keep_frac.astype(np.float32).copy()
    if overhead is not None:
        if protocol is None:
            keep[bank.leg_valid] = 1.0 - overhead
        else:
            pid = bank.protocol_names.index(protocol)
            keep[bank.protocol_id == pid] = 1.0 - overhead
    mu = bank.bg_mu if bg_mu is None else np.where(bank.link_valid, bg_mu, 0.0)
    sigma = (
        bank.bg_sigma if bg_sigma is None
        else np.where(bank.link_valid, bg_sigma, 0.0)
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    return SimParams(keep_frac=f32(keep), bg_mu=f32(mu), bg_sigma=f32(sigma))


def _rep3(field: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Lift a bank-wide ``[S, X]`` params field to broadcast against
    per-(scenario, replica) ``[S, R, X]`` state (no-op if already 3-D)."""
    if field is None or field.dim() == 3:
        return field
    return field[:, None, :]


def _banked_init_carry(spec: SimSpec, params: SimParams, keys: torch.Tensor) -> _Carry:
    """Initial ``[S, R, ...]`` carry (padded and disabled legs born done)."""
    S, T = spec.size_mb.shape
    L = spec.bandwidth.shape[-1]
    R = keys.shape[1]
    dev = spec.size_mb.device
    born_done = torch.zeros((S, R, T), dtype=torch.bool, device=dev)
    if params.enabled is not None:
        born_done |= ~_rep3(params.enabled).to(torch.bool)
    if spec.leg_valid is not None:
        born_done |= ~spec.leg_valid[:, None, :].to(torch.bool)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    return _Carry(
        t=zeros((S, R), torch.int32),
        remaining=spec.size_mb[:, None, :].expand(S, R, T).clone(),
        done=born_done,
        started=zeros((S, R, T), torch.bool),
        t_start=zeros((S, R, T), torch.int32),
        t_end=zeros((S, R, T), torch.int32),
        conth=zeros((S, R, T), torch.float32),
        conpr=zeros((S, R, T), torch.float32),
        bg=zeros((S, R, L), torch.float32),
        key=keys,
    )


def _banked_live(spec: SimSpec, c: _Carry) -> torch.Tensor:  # [S, R]
    return (c.t < spec.max_ticks[:, None]) & ~torch.all(c.done, dim=-1)


def _banked_result(spec: SimSpec, final: _Carry) -> SimResult:
    S, R, T = final.remaining.shape
    return SimResult(
        transfer_time=torch.where(
            final.done, (final.t_end - final.t_start).to(torch.float32), 0.0
        ),
        size_mb=spec.size_mb[:, None, :].expand(S, R, T),
        conth_mb=final.conth,
        conpr_mb=final.conpr,
        done=final.done,
        ticks=final.t,
        profile=spec.profile[:, None, :].expand(S, R, T),
        start_tick=final.t_start.to(torch.float32),
    )


def _bank_window_body(
    spec: SimSpec, params: SimParams, leap: bool, window: int, draw: bool, c: _Carry
) -> _Carry:
    """Advance the whole bank by one fused ``window``: one
    :func:`ops.grid_tick_bank_fused` call, each element's key advancing by
    exactly its alive-step count. ``draw`` says whether any ``sigma`` is
    positive (else the window splits keys and draws no normals)."""
    state = (
        c.t, torch.zeros_like(c.t), c.remaining, c.done, c.started,
        c.t_start, c.t_end, c.conth, c.conpr, c.bg,
    )
    (t, _steps, remaining, done, started, t_start, t_end, conth, conpr,
     bg), key = ops.grid_tick_bank_fused(
        state, _rep3(params.bg_mu), _rep3(params.bg_sigma),
        spec.release, spec.dep, spec.bg_period, spec.max_ticks,
        params.keep_frac, spec.bandwidth,
        spec.leg_proc, spec.proc_link, spec.leg_link,
        window=window, leap=leap, key=c.key,
        tables=spec.index_tables, draw=draw,
    )
    return _Carry(
        t=t, remaining=remaining, done=done, started=started,
        t_start=t_start, t_end=t_end, conth=conth, conpr=conpr, bg=bg,
        key=key,
    )


def _banked_core(
    spec: SimSpec, params: SimParams, keys: torch.Tensor, *, leap: bool, window: int
) -> SimResult:
    """The host loop of windows: run fused windows until no element is
    alive (one device-to-host read of the live flag per window)."""
    spec = with_index_tables(spec)
    draw = bool(torch.any(params.bg_sigma > 0))
    c = _banked_init_carry(spec, params, keys)
    while bool(torch.any(_banked_live(spec, c))):
        c = _bank_window_body(spec, params, leap, window, draw, c)
        STATS["windows"] += 1
    return _banked_result(spec, c)


#: Fused-window defaults per device type, (tick, leap). On the card every
#: window is one fused-kernel launch, so K amortizes the launch, the carry's
#: round trip through device memory and the host's live check; the pair is
#: the reference's TPU pair until a sweep on the card sets its own. On the
#: CPU the plain scan gains nothing from long windows.
_WINDOW_DEFAULTS = {"cuda": (32, 16)}
_WINDOW_DEFAULT_OTHER = (1, 1)


def default_tick_window(leap: bool = False, device: DeviceLike = None) -> int:
    """The fused-window size ``window=None`` resolves to on ``device``."""
    kind = torch.device("cuda" if device is None else device).type
    pair = _WINDOW_DEFAULTS.get(kind, _WINDOW_DEFAULT_OTHER)
    return pair[1] if leap else pair[0]


def _resolve_window(
    window: Optional[int], leap: bool = False, device: DeviceLike = None
) -> int:
    """``None`` -> the device's default; explicit values are validated."""
    if window is None:
        return default_tick_window(leap, device)
    w = int(window)
    if w < 1:
        raise ValueError(f"tick window must be >= 1: {window!r}")
    return w


def _clamp_window(window: int, tick_bound: int) -> int:
    """Cap a window at a bank's tick bound, quantized to the bound's next
    power of two (the reference's rule, kept so both packages pick the same
    K for the same bank)."""
    cap = 1
    while cap < tick_bound:
        cap *= 2
    return max(1, min(window, cap))


def simulate_bank(
    bank: Union[ScenarioBank, SimSpec],
    params: SimParams,
    keys: torch.Tensor,  # [N, R, 2] threefry keys (R replicas per scenario)
    *,
    leap: bool = False,
    bucketed: bool = True,
    window: Optional[int] = None,
    device: DeviceLike = None,
) -> SimResult:
    """Simulate every scenario of the bank x ``R`` stochastic replicas on
    ``device`` (default ``cuda``).

    Fields of the result carry ``[N, R]`` leading dims; padded legs report
    ``done=True`` with zero transfer. ``params`` fields may be bank-wide
    (``[N, ...]``) or per replica (``[N, R, ...]``); ``params`` and ``keys``
    move to ``device``. ``window=K`` fuses ``K`` ticks (``K`` event leaps
    under ``leap``) into each window, with results bit-identical for every
    ``K``; ``None`` takes the device's default, capped at the bank's tick
    bound. A :class:`BucketedBank` runs monolithically with
    ``bucketed=False``; its bucketed dispatch is not ported yet.
    """
    dev = resolve_device(device)
    if keys.dim() != 3:
        raise ValueError(
            f"keys must be [n_scenarios, n_replicas, 2]: {tuple(keys.shape)}"
        )
    if bucketed and isinstance(bank, BucketedBank):
        raise NotImplementedError(
            "bucketed bank dispatch is not ported yet (ROADMAP A.3); pass "
            "bucketed=False to run the bank monolithically"
        )
    w = _resolve_window(window, leap, dev)
    if isinstance(bank, ScenarioBank):
        w = _clamp_window(w, int(np.max(np.asarray(bank.max_ticks))))
        spec = bank_spec(bank, dev)
    else:
        spec = SimSpec(*(None if f is None else f.to(dev) for f in bank))
    params = SimParams(*(None if f is None else f.to(dev) for f in params))
    return _banked_core(spec, params, keys.to(dev), leap=leap, window=w)
