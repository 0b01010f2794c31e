"""GDAPS tick engine in PyTorch: one campaign, or a bank of them.

The port of the reference package's ``repro.core.engine``, in two parts.

- **Per campaign** (:func:`simulate`, :func:`simulate_batch`): ``B``
  simulations of one compiled campaign (an unstacked :class:`SimSpec`,
  :meth:`SimSpec.from_table`) advance as one ``[B, ...]`` carry, one
  :func:`ops.grid_tick` call per tick or event leap: one launch of the
  per-campaign tick on the card, and under ``leap`` one
  :func:`ops.grid_tick_sums` launch an event step for its last tick's
  sums. Every per-process and per-link float sum walks the campaign's
  lists (``ref.campaign_index_tables``) as the banked engine walks a
  scenario's, so the ``vmap`` lowering equals the banked one bitwise.
- **Banked** (:func:`simulate_bank`): a compiled scenario bank runs as one
  ``[S, R, ...]`` carry advanced by fused windows of ``K`` ticks (``K``
  event leaps under ``leap``), each window one call of
  :func:`ops.grid_tick_bank_fused`, one fused-kernel launch on the card in
  tick mode. ``lowering="vmap"`` instead runs each scenario through
  :func:`simulate_batch`, as a cross-check.

Both loop over windows on the host and stop when no simulation is alive;
results are bitwise the same for every ``K`` (the alive freeze is inside
the window). Bucketed dispatch, replica folding and the stepped
(checkpointed) loop of the banked engine are open ROADMAP items.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.workload import BucketedBank, LegTable, ScenarioBank
from repro_torch.kernels import ops, ref

__all__ = [
    "SimSpec",
    "SimParams",
    "SimResult",
    "resolve_device",
    "INDEX_TABLE_FIELDS",
    "with_index_tables",
    "make_params",
    "simulate",
    "simulate_batch",
    "bank_spec",
    "make_bank_params",
    "default_tick_window",
    "simulate_bank",
    "STATS",
]

#: Host-side counters of the window loops: windows run since the last reset.
STATS = {"windows": 0}


class SimSpec(NamedTuple):
    """Device tensors describing compiled campaigns, in one of two layouts.

    - **Unstacked**, one campaign (:meth:`from_table`): ``[T]``, ``[L]`` and
      ``[T, P]``-shaped fields and an ``int`` ``max_ticks``; what
      :func:`simulate` and :func:`simulate_batch` take.
    - **Stacked**, a bank (:func:`bank_spec`): every field has a leading
      ``[N]`` scenario dim, ``max_ticks`` is per scenario and ``leg_valid``
      masks the padding (padded legs are born done); what
      :func:`simulate_bank` takes.

    The index-table fields are the one-hot incidences as the kernels read
    them, filled by :func:`with_index_tables`: ``proc_of_leg``,
    ``link_of_leg`` and ``link_of_proc``, and beside them all of a bank's
    ``bank_tables`` (``ref.bank_index_tables``) or one campaign's
    ``campaign_tables`` (``ref.campaign_index_tables``: the same tables
    for a bank of one scenario)."""

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
    campaign_tables: Optional[ref.BankTables] = None  # unstacked only, S = 1
    bank_tables: Optional[ref.BankTables] = None  # stacked only

    @property
    def device(self) -> torch.device:
        return self.size_mb.device

    @staticmethod
    def from_table(
        table: LegTable, max_ticks: Optional[int] = None, device: "DeviceLike" = None
    ) -> "SimSpec":
        """The unstacked spec of one compiled campaign on ``device``
        (default ``cuda``), its index tables filled. ``max_ticks`` defaults
        to the table's upper bound."""
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        return with_index_tables(SimSpec(
            size_mb=t(table.size_mb), release=t(table.release), dep=t(table.dep),
            profile=t(table.profile), protocol_id=t(table.protocol_id),
            leg_proc=t(table.leg_proc_onehot()), proc_link=t(table.proc_link_onehot()),
            leg_link=t(table.leg_link_onehot()), bandwidth=t(table.links.bandwidth),
            bg_period=t(table.links.bg_period),
            max_ticks=(int(max_ticks) if max_ticks is not None
                       else table.max_ticks_upper_bound()),
        ))

    @property
    def n_legs(self) -> int:
        return self.size_mb.shape[-1]

    @property
    def n_links(self) -> int:
        return self.bandwidth.shape[-1]


class SimParams(NamedTuple):
    """Runtime parameters: per-leg keep fraction and per-link background-load
    moments; ``enabled`` masks legs out of the campaign (born done). For one
    campaign each field is shared (``[T]`` / ``[L]``) or per simulation
    (``[B, T]`` / ``[B, L]``); on a bank, bank-wide ``[N, X]`` or per
    replica ``[N, R, X]``."""

    keep_frac: torch.Tensor  # [T] / [N, T] f32 = 1 - overhead per leg
    bg_mu: torch.Tensor  # [L] / [N, L] f32
    bg_sigma: torch.Tensor  # [L] / [N, L] f32
    enabled: Optional[torch.Tensor] = None  # [T] / [N, T] bool (None = all enabled)


class SimResult(NamedTuple):
    """Per-leg observation record (the paper's (T, S, ConTh, ConPr) tuples):
    ``[T]`` per field and ``[]`` for ``ticks`` from :func:`simulate`, with a
    leading ``[B]`` from :func:`simulate_batch` and ``[N, R]`` from
    :func:`simulate_bank`."""

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
INDEX_TABLE_FIELDS = (
    "proc_of_leg", "link_of_leg", "link_of_proc", "campaign_tables", "bank_tables",
)


def with_index_tables(spec: SimSpec) -> SimSpec:
    """``spec`` with its index tables derived from its incidences, unless it
    already carries them: ``ref.bank_index_tables`` for a stacked bank,
    ``ref.campaign_index_tables`` for one campaign."""
    if spec.proc_of_leg is not None:
        return spec
    if spec.size_mb.dim() == 1:
        ct = ref.campaign_index_tables(spec.leg_proc, spec.proc_link, spec.leg_link)
        return spec._replace(proc_of_leg=ct.proc_of_leg[0], link_of_leg=ct.link_of_leg[0],
                             link_of_proc=ct.link_of_proc[0], campaign_tables=ct)
    bt = ref.bank_index_tables(spec.leg_proc, spec.proc_link, spec.leg_link)
    return spec._replace(proc_of_leg=bt.proc_of_leg, link_of_leg=bt.link_of_leg,
                         link_of_proc=bt.link_of_proc, bank_tables=bt)


def make_params(
    table: LegTable,
    *,
    overhead: Optional[float] = None,
    bg_mu: Optional[float] = None,
    bg_sigma: Optional[float] = None,
    protocol: Optional[str] = None,
    device: DeviceLike = None,
) -> SimParams:
    """:class:`SimParams` of one campaign (``[T]`` keep, ``[L]`` moments) on
    ``device``, optionally overriding the overhead of one protocol (or of
    every leg) and the background moments of every link: the knobs the
    paper calibrates (theta)."""
    dev = resolve_device(device)
    keep = table.keep_frac.astype(np.float32).copy()
    if overhead is not None:
        if protocol is None:
            keep[:] = 1.0 - overhead
        else:
            pid = table.protocol_names.index(protocol)
            keep[table.protocol_id == pid] = 1.0 - overhead
    links = table.links
    mu = links.bg_mu if bg_mu is None else np.full_like(links.bg_mu, bg_mu)
    sigma = links.bg_sigma if bg_sigma is None else np.full_like(links.bg_sigma, bg_sigma)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    return SimParams(keep_frac=f32(keep), bg_mu=f32(mu), bg_sigma=f32(sigma))


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
        tables=spec.bank_tables, draw=draw,
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


# ---------------------------------------------------------------------------
# Per-campaign engine: B simulations of one campaign as one [B, ...] carry
# ---------------------------------------------------------------------------


def _sim_init_carry(spec: SimSpec, params: SimParams, keys: torch.Tensor) -> _Carry:
    """Initial ``[B, ...]`` carry (disabled and padded legs born done)."""
    B, T, L = keys.shape[0], spec.n_legs, spec.n_links
    dev = spec.device
    born_done = torch.zeros((B, T), dtype=torch.bool, device=dev)
    if params.enabled is not None:
        born_done |= ~params.enabled.to(torch.bool)
    if spec.leg_valid is not None:
        born_done |= ~spec.leg_valid.to(torch.bool)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    return _Carry(
        t=zeros((B,), torch.int32),
        remaining=spec.size_mb.expand(B, T).clone(),
        done=born_done,
        started=zeros((B, T), torch.bool),
        t_start=zeros((B, T), torch.int32),
        t_end=zeros((B, T), torch.int32),
        conth=zeros((B, T), torch.float32),
        conpr=zeros((B, T), torch.float32),
        bg=zeros((B, L), torch.float32),
        key=keys,
    )


def _sim_live(spec: SimSpec, c: _Carry) -> torch.Tensor:  # [B]
    return (c.t < spec.max_ticks) & ~torch.all(c.done, dim=-1)


def _sim_noise_chain(key: torch.Tensor, window: int, n_links: int):
    """One window of background noise drawn ahead: ``window`` splits of
    every ``[B, 2]`` key in the reference's order (``key, sub =
    split(key)``, then ``normal(sub, (L,))``), as the key chain ``[K + 1,
    B, 2]`` (entry ``j`` is the key after ``j`` splits) and the normals
    ``[K, B, L]``, drawn in one call. A simulation alive for ``j`` steps of
    the window resumes from ``chain[j]``."""
    keys, subs = [key], []
    for _ in range(window):
        pair = prng.split(key, 2)
        key = pair[..., 0, :]
        keys.append(key)
        subs.append(pair[..., 1, :])
    return torch.stack(keys), prng.normal(torch.stack(subs), (n_links,))


def _sim_step(
    spec: SimSpec, params: SimParams, leap: bool, c: _Carry,
    alive: torch.Tensor, noise: Optional[torch.Tensor],
) -> _Carry:
    """One tick (one event leap under ``leap``) of every simulation, the
    reference's ``_tick_body`` / ``_leap_body`` expression by expression on
    a ``[B, ...]`` carry. ``alive [B]`` masks every update, so a finished
    simulation's carry passes through bitwise; ``noise [B, L]`` are this
    step's normals (``None``: every ``sigma`` is 0). The key is advanced by
    the window, not here."""
    f32, i32 = torch.float32, torch.int32
    t = c.t
    t2 = t[:, None]
    alive2 = alive[:, None]
    if noise is None:
        fresh = torch.clamp_min(params.bg_mu, 0.0).expand_as(c.bg)
    else:
        fresh = torch.clamp_min(prng.fma(params.bg_sigma, noise, params.bg_mu), 0.0)
    due = (t2 % spec.bg_period == 0) & alive2
    bg = torch.where(due, fresh, c.bg)

    dep_done = torch.where(spec.dep >= 0, c.done[:, spec.dep.clamp_min(0).long()], True)
    active = ~c.done & (spec.release <= t2) & dep_done & alive2
    a = active.to(f32)
    tick = lambda rem: ops.grid_tick(
        a, rem, params.keep_frac, bg, spec.bandwidth,
        spec.leg_proc, spec.proc_link, spec.leg_link, tables=spec.campaign_tables,
    )
    proc_of_leg = spec.proc_of_leg.long()
    link_of_leg = spec.link_of_leg.long()

    if not leap:
        xfer, proc_xfer, link_xfer = tick(c.remaining)
        remaining = c.remaining - xfer
        newly_done = active & (remaining <= 1e-6)
        own_proc = proc_xfer[:, proc_of_leg]
        own_link = link_xfer[:, link_of_leg]
        conth = c.conth + a * (own_proc - xfer)
        conpr = c.conpr + a * (own_link - own_proc)
        t_end = torch.where(newly_done, t2 + 1, c.t_end)
        adv = alive.to(i32)
    else:
        rate, proc_rate, link_rate = tick(torch.full_like(c.remaining, float("inf")))
        inf = torch.tensor(float("inf"), dtype=f32, device=rate.device)
        ttc = torch.where(
            active & (rate > 0), torch.ceil(c.remaining / torch.clamp_min(rate, 1e-30)), inf
        )
        pending = ~c.done & (spec.release > t2)
        t_rel = torch.where(pending, (spec.release - t2).to(f32), inf)
        # sigma=0 links hold bg = max(mu, 0) from t=0 forever: their
        # resample ticks are rate no-ops and never throttle dt
        t_bg = torch.where(
            params.bg_sigma > 0, (spec.bg_period - t2 % spec.bg_period).to(f32), inf
        )
        dt = torch.minimum(
            torch.minimum(ttc.amin(dim=-1), t_rel.amin(dim=-1)), t_bg.amin(dim=-1)
        )  # [B]
        dt = torch.where(torch.isfinite(dt), torch.clamp_min(dt, 1.0), 1.0)
        dt1 = (dt - 1.0)[:, None].expand_as(rate)
        # dt - 1 rate-exact ticks, then the final (possibly clipped) tick
        rem_mid = prng.fma(-(a * rate), dt1, c.remaining)
        xfer_f = torch.minimum(rem_mid, rate) * a
        proc_xfer_f, link_xfer_f = ops.grid_tick_sums(xfer_f, spec.campaign_tables)
        remaining = rem_mid - xfer_f
        own_proc_rate = proc_rate[:, proc_of_leg]
        own_link_rate = link_rate[:, link_of_leg]
        own_proc_f = proc_xfer_f[:, proc_of_leg]
        own_link_f = link_xfer_f[:, link_of_leg]
        conth = c.conth + a * prng.fma(own_proc_rate - rate, dt1, own_proc_f - xfer_f)
        conpr = c.conpr + a * prng.fma(
            own_link_rate - own_proc_rate, dt1, own_link_f - own_proc_f
        )
        newly_done = active & (remaining <= 1e-6)
        t_end = torch.where(newly_done, t2 + dt.to(i32)[:, None], c.t_end)
        adv = dt.to(i32) * alive.to(i32)
    return _Carry(
        t=t + adv,
        remaining=remaining,
        done=c.done | newly_done,
        started=c.started | active,
        t_start=torch.where(active & ~c.started, t2, c.t_start),
        t_end=t_end,
        conth=conth,
        conpr=conpr,
        bg=bg,
        key=c.key,
    )


def _sim_window(
    spec: SimSpec, params: SimParams, leap: bool, window: int, draw: bool, c: _Carry
) -> _Carry:
    """``window`` masked steps of every simulation: the window's noise drawn
    ahead, each step's alive mask re-evaluated (a simulation finishing
    mid-window stops exactly there), each key resumed from the chain at its
    alive-step count."""
    chain = noise = None
    if draw:
        chain, noise = _sim_noise_chain(c.key, window, spec.n_links)
    steps = torch.zeros_like(c.t)
    for i in range(window):
        alive = _sim_live(spec, c)
        c = _sim_step(spec, params, leap, c, alive, None if noise is None else noise[i])
        steps = steps + alive.to(steps.dtype)
    if chain is not None:
        idx = steps.long()[None, :, None].expand(1, steps.shape[0], 2)
        c = c._replace(key=torch.gather(chain, 0, idx)[0])
    return c


def _sim_result(spec: SimSpec, final: _Carry) -> SimResult:
    B, T = final.remaining.shape
    return SimResult(
        transfer_time=torch.where(
            final.done, (final.t_end - final.t_start).to(torch.float32), 0.0
        ),
        size_mb=spec.size_mb.expand(B, T),
        conth_mb=final.conth,
        conpr_mb=final.conpr,
        done=final.done,
        ticks=final.t,
        profile=spec.profile.expand(B, T),
        start_tick=final.t_start.to(torch.float32),
    )


def simulate_batch(
    spec: SimSpec,
    params: SimParams,
    keys: torch.Tensor,  # [B, 2] threefry keys
    *,
    leap: bool = False,
    window: Optional[int] = None,
) -> SimResult:
    """``B`` stochastic simulations of one campaign, on the device of
    ``spec`` (an unstacked :class:`SimSpec`, :meth:`SimSpec.from_table`).

    Each ``params`` field may be shared (``[T]`` / ``[L]``) or carry a
    leading ``[B]`` (one theta or one ``enabled`` mask per simulation);
    ``params`` and ``keys`` move to the spec's device. Fields of the result
    are ``[B, T]`` (``ticks`` ``[B]``); legs that never finish within
    ``max_ticks`` have ``done=False`` and ``transfer_time=0``. ``leap=True``
    runs the exact event-leap engine. ``window=K`` runs ``K`` steps between
    the host's liveness checks, with results bitwise the same for every
    ``K``; ``None`` takes the device's default, capped at ``max_ticks``.
    """
    if spec.size_mb.dim() != 1:
        raise ValueError(
            "simulate_batch takes one campaign's unstacked SimSpec "
            f"(SimSpec.from_table); got size_mb {tuple(spec.size_mb.shape)}"
        )
    if keys.dim() != 2 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [B, 2]: {tuple(keys.shape)}")
    dev = spec.device
    # a converted reference spec carries max_ticks as a 0-d array
    spec = with_index_tables(spec._replace(max_ticks=int(spec.max_ticks)))
    params = SimParams(*(None if f is None else f.to(dev) for f in params))
    w = _clamp_window(_resolve_window(window, leap, dev), spec.max_ticks)
    draw = bool(torch.any(params.bg_sigma > 0))
    c = _sim_init_carry(spec, params, keys.to(dev))
    while bool(torch.any(_sim_live(spec, c))):
        c = _sim_window(spec, params, leap, w, draw, c)
        STATS["windows"] += 1
    return _sim_result(spec, c)


def simulate(
    spec: SimSpec,
    params: SimParams,
    key: torch.Tensor,  # [2]
    *,
    leap: bool = False,
    window: Optional[int] = None,
) -> SimResult:
    """One stochastic simulation of the campaign: :func:`simulate_batch`
    of one key, with ``[T]`` fields and a ``[]`` ``ticks``. ``params`` must
    be shared (no leading batch dim)."""
    res = simulate_batch(spec, params, key.reshape(1, 2), leap=leap, window=window)
    return SimResult(*(f[0] for f in res))



def simulate_bank(
    bank: Union[ScenarioBank, SimSpec],
    params: SimParams,
    keys: torch.Tensor,  # [N, R, 2] threefry keys (R replicas per scenario)
    *,
    leap: bool = False,
    bucketed: bool = True,
    window: Optional[int] = None,
    device: DeviceLike = None,
    lowering: Optional[str] = None,
) -> SimResult:
    """Simulate every scenario of the bank x ``R`` stochastic replicas on
    ``device`` (default ``cuda``).

    ``lowering`` is ``"banked"`` (the default, ``None``): the whole bank as
    one carry; or ``"vmap"``, a cross-check that runs each scenario as one
    campaign through :func:`simulate_batch` over its replicas (padded legs
    born done through ``leg_valid``), as the reference's ``vmap`` lowering
    runs ``simulate`` per scenario.

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
    if lowering not in (None, "banked", "vmap"):
        raise ValueError(f"lowering must be 'banked' or 'vmap': {lowering!r}")
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
    if lowering == "vmap":
        return _vmap_bank(spec, params, keys.to(dev), leap=leap, window=window)
    return _banked_core(spec, params, keys.to(dev), leap=leap, window=w)


def _vmap_bank(
    spec: SimSpec, params: SimParams, keys: torch.Tensor, *, leap: bool,
    window: Optional[int],
) -> SimResult:
    """The ``vmap`` lowering: scenario ``i`` of the stacked ``spec`` runs
    as one unstacked campaign through :func:`simulate_batch`, its ``R``
    replicas the batch; results stacked back to ``[N, R, ...]``."""
    bank_fields = [f for f in SimSpec._fields if f not in INDEX_TABLE_FIELDS]
    row = lambda f, i: None if f is None else f[i]
    runs = []
    for i in range(keys.shape[0]):
        one = SimSpec(**{f: getattr(spec, f)[i] for f in bank_fields})
        p = SimParams(*(row(f, i) for f in params))
        runs.append(simulate_batch(one, p, keys[i], leap=leap, window=window))
    return SimResult(*(torch.stack(fs) for fs in zip(*runs)))
