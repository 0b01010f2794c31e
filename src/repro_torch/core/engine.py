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
the window).

A :class:`BucketedBank` runs bucket by bucket (:func:`simulate_bank`'s
bucketed dispatch): each sub-bank at its own pads and its own clamped
window, its params gathered by scenario id, its results scattered back
into the caller's ``[N, R]`` order; a singleton bucket folds its replicas
into scenario rows (:func:`_replica_fold`), which changes no bit.
:func:`simulate_bank_stepped` is the same banked loop driven window by
window from the host with a bounded trip count, checkpoints
(:class:`BankCheckpoint`) and resume; :func:`_admit_bank_rows` and
:func:`_bank_snapshot` are the seams a serving loop steps a resident bank
with (:class:`repro_torch.core.residency.ResidentBank`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.workload import PAD_PROFILE, BucketedBank, LegTable, ScenarioBank
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
    "simulate_bank_stepped",
    "BankCheckpoint",
    "STATS",
]

#: Host-side counters of the window loops: windows run and buckets
#: dispatched (one a bucket a bucketed run) since the last reset.
STATS = {"windows": 0, "buckets": 0}


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


def _bank_spec_uncached(bank: ScenarioBank, dev: torch.device) -> SimSpec:
    """The stacked spec of ``bank`` uploaded to ``dev`` anew, its index
    tables built from the bank's current rows. The host arrays are copied,
    so a CPU spec shares no memory with a bank whose rows are rewritten
    (``ResidentBank.write_rows``)."""
    t = lambda a: torch.as_tensor(np.array(a)).to(dev)
    return with_index_tables(SimSpec(
        size_mb=t(bank.size_mb), release=t(bank.release), dep=t(bank.dep),
        profile=t(bank.profile), protocol_id=t(bank.protocol_id),
        leg_proc=t(bank.leg_proc), proc_link=t(bank.proc_link),
        leg_link=t(bank.leg_link), bandwidth=t(bank.bandwidth),
        bg_period=t(bank.bg_period), max_ticks=t(bank.max_ticks),
        leg_valid=t(bank.leg_valid),
    ))


def bank_spec(bank: ScenarioBank, device: DeviceLike = None) -> SimSpec:
    """The stacked ``[N, ...]`` SimSpec of a compiled bank on ``device``,
    memoized per device on the bank (compiled banks are immutable)."""
    dev = resolve_device(device)
    cache = bank.__dict__.setdefault("_torch_spec_cache", {})
    spec = cache.get(str(dev))
    if spec is None:
        spec = _bank_spec_uncached(bank, dev)
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


def _resolve_lowering(lowering: Optional[str]) -> str:
    """``None`` and ``"auto"`` (a reference save's default) resolve to
    ``"banked"``; ``"vmap"`` is the cross-check."""
    if lowering in (None, "auto", "banked"):
        return "banked"
    if lowering == "vmap":
        return "vmap"
    raise ValueError(f"lowering must be 'banked' or 'vmap': {lowering!r}")


def _to_device_spec(bank: Union[ScenarioBank, SimSpec], dev: torch.device) -> SimSpec:
    if isinstance(bank, ScenarioBank):
        return bank_spec(bank, dev)
    return SimSpec(*(None if f is None else f.to(dev) for f in bank))


def _tick_bound(bank: Union[ScenarioBank, SimSpec]) -> int:
    """The largest ``max_ticks`` of a bank or a stacked spec."""
    if isinstance(bank, ScenarioBank):
        return int(np.max(np.asarray(bank.max_ticks)))
    return int(bank.max_ticks.max())


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

    ``lowering`` is ``"banked"`` (the default, ``None`` or ``"auto"``): the
    whole bank as one carry; or ``"vmap"``, a cross-check that runs each
    scenario as one campaign through :func:`simulate_batch` over its
    replicas (padded legs born done through ``leg_valid``), as the
    reference's ``vmap`` lowering runs ``simulate`` per scenario.

    Fields of the result carry ``[N, R]`` leading dims; padded legs report
    ``done=True`` with zero transfer. ``params`` fields may be bank-wide
    (``[N, ...]``) or per replica (``[N, R, ...]``); ``params`` and ``keys``
    move to ``device``. ``window=K`` fuses ``K`` ticks (``K`` event leaps
    under ``leap``) into each window, with results bit-identical for every
    ``K``; ``None`` takes the device's default, capped at the bank's tick
    bound.

    A :class:`BucketedBank` runs bucket by bucket (each sub-bank at its own
    pads until its own slowest scenario finishes, its window capped at its
    own tick bound) and its results are scattered back into the caller's
    ``[N, R]`` order, bitwise those of the monolithic run; ``bucketed=False``
    runs it monolithically.
    """
    dev = resolve_device(device)
    if keys.dim() != 3:
        raise ValueError(
            f"keys must be [n_scenarios, n_replicas, 2]: {tuple(keys.shape)}"
        )
    lowering = _resolve_lowering(lowering)
    w = _resolve_window(window, leap, dev)
    if isinstance(bank, ScenarioBank):
        w = _clamp_window(w, _tick_bound(bank))
    params = SimParams(*(None if f is None else f.to(dev) for f in params))
    keys = keys.to(dev)
    if bucketed and isinstance(bank, BucketedBank):
        return _simulate_bank_bucketed(bank, params, keys, leap=leap, lowering=lowering,
                                       window=w, dev=dev)
    spec = _to_device_spec(bank, dev)
    if lowering == "vmap":
        return _vmap_bank(spec, params, keys, leap=leap, window=w)
    return _banked_core(spec, params, keys, leap=leap, window=w)


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


# ---------------------------------------------------------------------------
# Bucketed dispatch
# ---------------------------------------------------------------------------

# A cost-packed bank splits long-tail scenarios into singleton buckets at
# their native pads, whose runs hold one scenario row. The dispatch folds
# such a bucket's [1, R] elements into [fold, R / fold] rows, the spec
# repeated over the folded rows: the engine is element-independent (each
# element's freeze mask and key), so every element's trajectory and the
# number of windows are unchanged and no bit moves. The fold is capped so
# the repeated spec stays small.
_SINGLETON_FOLD_MAX = 8


def _replica_fold(n_replicas: int) -> int:
    """Largest power of two <= _SINGLETON_FOLD_MAX dividing n_replicas."""
    fold = 1
    while fold * 2 <= _SINGLETON_FOLD_MAX and n_replicas % (fold * 2) == 0:
        fold *= 2
    return fold


def _folded_spec(bucket_bank: ScenarioBank, fold: int, dev: torch.device) -> SimSpec:
    """The one-scenario spec of ``bucket_bank`` repeated over ``fold`` rows,
    memoized per fold and device on the bank. The base fields are repeated
    contiguously (the kernels take contiguous tensors) and the index tables
    rebuilt for the repeated rows."""
    cache = bucket_bank.__dict__.setdefault("_torch_fold_cache", {})
    key = (fold, str(dev))
    spec = cache.get(key)
    if spec is None:
        base = bank_spec(bucket_bank, dev)
        widened = {
            f: getattr(base, f).expand((fold,) + tuple(getattr(base, f).shape[1:])).contiguous()
            for f in SimSpec._fields
            if f not in INDEX_TABLE_FIELDS and getattr(base, f) is not None
        }
        spec = with_index_tables(SimSpec(**widened))
        cache[key] = spec
    return spec


def _bucket_ids(bank: BucketedBank, dev: torch.device):
    """Per bucket ``(ids, gid)`` on ``dev``: the real scenario ids, and the
    gather index extended with the last real id over the bucket's shard-pad
    rows (never live, so their params and keys are irrelevant). Memoized per
    device on the bank."""
    cache = bank.__dict__.setdefault("_torch_bucket_ids", {})
    out = cache.get(str(dev))
    if out is None:
        out = []
        for b in bank.buckets:
            ids = np.asarray(b.scenario_ids, np.int64)
            pad = b.bank.n_scenarios - len(ids)
            gid = np.concatenate([ids, np.repeat(ids[-1:], pad)]) if pad else ids
            out.append((torch.as_tensor(ids).to(dev), torch.as_tensor(gid).to(dev)))
        cache[str(dev)] = out
    return out


def _simulate_bank_bucketed(
    bank: BucketedBank, params: SimParams, keys: torch.Tensor, *, leap: bool,
    lowering: str, window: int, dev: torch.device,
) -> SimResult:
    """Run every bucket of ``bank`` and scatter its results into ``[N, R,
    pad_legs]`` outputs pre-filled with the padding contract (born done,
    zeros, ``PAD_PROFILE``). Each bucket gathers its rows of the bank-wide
    (or per-replica) params by scenario id, sliced to its own pads, and runs
    at ``window`` capped at its own tick bound; shard-pad rows are run and
    dropped before the scatter."""
    if keys.shape[0] != bank.n_scenarios:
        raise ValueError(
            f"keys must be [n_scenarios={bank.n_scenarios}, R, 2]: {tuple(keys.shape)}"
        )
    n, r = keys.shape[:2]
    T = bank.pad_legs
    f32 = torch.float32
    z = lambda dt: torch.zeros((n, r, T), dtype=dt, device=dev)
    out = SimResult(
        transfer_time=z(f32), size_mb=z(f32), conth_mb=z(f32), conpr_mb=z(f32),
        done=torch.ones((n, r, T), dtype=torch.bool, device=dev),
        ticks=torch.zeros((n, r), dtype=torch.int32, device=dev),
        profile=torch.full((n, r, T), PAD_PROFILE, dtype=torch.int32, device=dev),
        start_tick=z(f32),
    )
    bank_wide = all(f is None or f.dim() == 2 for f in params)
    for b, (ids, gid) in zip(bank.buckets, _bucket_ids(bank, dev)):
        sub = b.bank
        t_b, l_b = sub.pad_legs, sub.pad_links
        n_real, s_b = ids.shape[0], sub.n_scenarios
        w_b = _clamp_window(window, _tick_bound(sub))
        legs = lambda f: None if f is None else f[gid][..., :t_b]
        links = lambda f: None if f is None else f[gid][..., :l_b]
        sub_params = SimParams(
            keep_frac=legs(params.keep_frac), bg_mu=links(params.bg_mu),
            bg_sigma=links(params.bg_sigma), enabled=legs(params.enabled),
        )
        fold = _replica_fold(r) if s_b == 1 and n_real == 1 and r > 1 and bank_wide else 1
        if fold > 1:
            spec_b = _folded_spec(sub, fold, dev)
            widen = lambda f: None if f is None else f.expand(
                (fold,) + tuple(f.shape[1:])).contiguous()
            sub_params = SimParams(*(widen(f) for f in sub_params))
            sub_keys = keys[gid].reshape(fold, r // fold, 2)
        else:
            spec_b = bank_spec(sub, dev)
            sub_keys = keys[gid]
        if lowering == "vmap":
            res = _vmap_bank(spec_b, sub_params, sub_keys, leap=leap, window=w_b)
        else:
            res = _banked_core(spec_b, sub_params, sub_keys, leap=leap, window=w_b)
        STATS["buckets"] += 1
        if fold > 1:
            res = SimResult(*(f.reshape((1, r) + tuple(f.shape[2:])) for f in res))
        if s_b != n_real:
            res = SimResult(*(f[:n_real] for f in res))
        for name in SimResult._fields:
            dst = getattr(out, name)
            if name == "ticks":
                dst[ids] = getattr(res, name)
            else:
                dst[ids, :, :t_b] = getattr(res, name)
    return out


# ---------------------------------------------------------------------------
# The stepped loop, checkpoints and the serving seams
# ---------------------------------------------------------------------------


class BankCheckpoint(NamedTuple):
    """Resumable snapshot of a host-driven banked run
    (:func:`simulate_bank_stepped`): the windows run so far, the window, and
    host (numpy) copies of the ``[S, R, ...]`` carry, which later steps do
    not touch (``Fleet.save_checkpoint`` writes them with ``np.savez``)."""

    windows_done: int
    window: int
    carry: _Carry


def _snapshot_carry(carry: _Carry) -> _Carry:
    return _Carry(*(x.detach().cpu().numpy().copy() for x in carry))


def _upload_carry(carry: _Carry, dev: torch.device) -> _Carry:
    """A host carry on ``dev``; a reference checkpoint's ``uint32`` key
    becomes the port's ``int64``."""
    up = lambda name, a: torch.as_tensor(
        np.asarray(a).astype(np.int64) if name == "key" else np.array(a)).to(dev)
    return _Carry(*(up(name, a) for name, a in zip(_Carry._fields, carry)))


def _validate_resume_carry(carry: _Carry, spec: SimSpec, keys: torch.Tensor) -> None:
    """Reject a resume carry whose shapes do not match the target bank: a
    checkpoint of another bank (other pads, scenario or replica counts)
    would fail deep in a window or, at a same-rank mismatch, simulate
    garbage."""
    S, R = keys.shape[0], keys.shape[1]
    T = spec.size_mb.shape[-1]
    L = spec.bandwidth.shape[-1]
    expect = {
        "t": (S, R), "remaining": (S, R, T), "done": (S, R, T), "started": (S, R, T),
        "t_start": (S, R, T), "t_end": (S, R, T), "conth": (S, R, T), "conpr": (S, R, T),
        "bg": (S, R, L), "key": (S, R, 2),
    }
    for field, want in expect.items():
        got = tuple(np.shape(getattr(carry, field)))
        if got != want:
            raise ValueError(
                f"checkpoint carry field {field!r} has shape {got} but the "
                f"target bank expects {want} (scenarios={S}, replicas={R}, "
                f"pad_legs={T}, pad_links={L}): the checkpoint was taken "
                "against a bank with other pads, scenarios or replicas and "
                "cannot resume this one"
            )


def simulate_bank_stepped(
    bank: Union[ScenarioBank, SimSpec],
    params: SimParams,
    keys: torch.Tensor,  # [S, R, 2]
    *,
    leap: bool = False,
    window: Optional[int] = None,
    sync_every: Optional[int] = 8,
    checkpoint_every: Optional[int] = None,
    on_checkpoint: Optional[Callable[[BankCheckpoint], None]] = None,
    resume: Optional[BankCheckpoint] = None,
    device: DeviceLike = None,
) -> SimResult:
    """The banked simulation as a host-driven loop of window steps, bitwise
    :func:`simulate_bank` (monolithic, ``lowering="banked"``) at the same
    resolved window.

    The window is resolved and clamped as :func:`simulate_bank` does; the
    loop runs at most ``ceil(max_ticks / window)`` windows (windows past an
    element's end are frozen no-ops) and checks on the host every
    ``sync_every`` windows whether any element is alive, stopping early
    (``None``: never checks). Each step rebinds the carry: a window's
    outputs are new tensors. Every ``checkpoint_every`` windows,
    ``on_checkpoint`` receives a :class:`BankCheckpoint` with a host copy
    of the carry; passing one back as ``resume`` uploads the carry and
    continues from its window, bitwise, since each window is a function of
    the carry alone. The checkpoint must come from this bank and window:
    other shapes or another window raise ``ValueError``.
    """
    dev = resolve_device(device)
    if keys.dim() != 3:
        raise ValueError(f"keys must be [n_scenarios, n_replicas, 2]: {tuple(keys.shape)}")
    spec = with_index_tables(_to_device_spec(bank, dev))
    params = SimParams(*(None if f is None else f.to(dev) for f in params))
    bound = _tick_bound(bank)
    w = _clamp_window(_resolve_window(window, leap, dev), bound)
    start = 0
    if resume is not None:
        if int(resume.window) != w:
            raise ValueError(
                f"checkpoint was taken at window={resume.window}, cannot "
                f"resume at window={w} (windows_done would not align)"
            )
        start = int(resume.windows_done)
        _validate_resume_carry(resume.carry, spec, keys)
        carry = _upload_carry(resume.carry, dev)
    else:
        carry = _banked_init_carry(spec, params, keys.to(dev).clone())
    draw = bool(torch.any(params.bg_sigma > 0))
    for i in range(start, max(1, -(-bound // w))):
        carry = _bank_window_body(spec, params, leap, w, draw, carry)
        STATS["windows"] += 1
        if (checkpoint_every is not None and on_checkpoint is not None
                and (i + 1) % checkpoint_every == 0):
            on_checkpoint(BankCheckpoint(windows_done=i + 1, window=w,
                                         carry=_snapshot_carry(carry)))
        if (sync_every is not None and (i + 1) % sync_every == 0
                and not bool(torch.any(_banked_live(spec, carry)))):
            break
    return _banked_result(spec, carry)


def _admit_bank_rows(
    spec: SimSpec,
    params: SimParams,
    keys: torch.Tensor,  # [S, R, 2]
    carry: _Carry,
    mask: torch.Tensor,  # [S] bool: rows to (re)initialize
) -> _Carry:
    """Merge freshly admitted scenario rows into a running carry: ``spec``,
    ``params`` and ``keys`` are the full ``[S, ...]`` views with the new
    scenarios written into their rows, ``mask`` selects those rows. Masked
    rows restart from :func:`_banked_init_carry`; every other row passes
    through bitwise, keys included."""
    fresh = _banked_init_carry(spec, params, keys)
    mask = mask.to(device=carry.t.device, dtype=torch.bool)

    def merge(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.reshape((mask.shape[0],) + (1,) * (old.dim() - 1)), new, old)

    return _Carry(*(merge(n, o) for n, o in zip(fresh, carry)))


def _bank_snapshot(spec: SimSpec, carry: _Carry):
    """``([S] row liveness, bank SimResult)`` of a carry. The result holds
    no buffer of the carry (the carry-backed fields are copied), so it
    stays as it is whatever a later step does with the carry."""
    live = torch.any(_banked_live(spec, carry), dim=-1)
    res = _banked_result(spec, carry)
    return live, res._replace(ticks=res.ticks.clone(), done=res.done.clone(),
                              conth_mb=res.conth_mb.clone(), conpr_mb=res.conpr_mb.clone())
