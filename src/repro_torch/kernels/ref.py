"""Plain PyTorch versions of the grid-tick, SELU-MLP and attention / mLSTM
kernels.

Each function is the port's semantic ground truth for one CUDA kernel: the
CPU path runs it directly, the tests hold it against the reference package's
``repro.kernels.ref``, and ``chip_smoke.py`` holds each kernel against it on
the card. The operation order follows the reference expression by
expression, because the integer-valued fields (done ticks, clocks) depend on
the rounding of the float ones.

Where XLA on the CPU contracts a multiply and an add into one fused
multiply-add (``mu + sigma * noise``, the leap's
``remaining - a * rate * (dt - 1)``), this module calls :func:`prng.fma`, so
the CPU path rounds as the reference does and the CUDA kernels use
``__fmaf_rn`` at the same places.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch.nn.functional as F

import torch

from repro_torch.core import prng

__all__ = [
    "BANK_WINDOW_STATE_FIELDS",
    "grid_tick",
    "bank_split_draw",
    "SegmentPlan",
    "BankTables",
    "bank_sums",
    "bank_index_tables",
    "campaign_index_tables",
    "grid_tick_indexed",
    "grid_tick_bank_indexed",
    "grid_tick_bank_window",
    "SELU_ALPHA",
    "SELU_SCALE",
    "selu",
    "selu_mlp",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_magnitudes",
    "decode_attention",
    "mlstm_chunk",
    "mlstm_chunk_chunked",
    "mlstm_chunk_tc",
]

Tick = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

#: Window-body carry layout shared by the plain scan, the fused CUDA kernel
#: and the engine: per-(scenario, replica) tick clock and alive-step count,
#: then the per-leg transfer state, then the per-link background load.
BANK_WINDOW_STATE_FIELDS = (
    "t",          # [S, R] i32 current tick of each (scenario, replica)
    "steps",      # [S, R] i32 alive inner steps taken inside this window
    "remaining",  # [S, R, T] f32 MB left per leg
    "done",       # [S, R, T] bool
    "started",    # [S, R, T] bool
    "t_start",    # [S, R, T] i32 first active tick
    "t_end",      # [S, R, T] i32 completion tick
    "conth",      # [S, R, T] f32 sibling-thread traffic accumulator
    "conpr",      # [S, R, T] f32 other-process traffic accumulator
    "bg",         # [S, R, L] f32 current background load
)


def grid_tick(
    active: torch.Tensor,  # [..., T] in {0, 1}
    remaining: torch.Tensor,  # [..., T] f32 MB
    keep_frac: torch.Tensor,  # [..., T] f32 = 1 - protocol overhead
    bg_load: torch.Tensor,  # [..., L] f32 background processes
    bandwidth: torch.Tensor,  # [..., L] f32 MB/tick
    leg_proc: torch.Tensor,  # [..., T, P] f32 one-hot
    proc_link: torch.Tensor,  # [..., P, L] f32 one-hot
    leg_link: torch.Tensor,  # [..., T, L] f32 one-hot
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fair-share tick: ``(xfer[..., T], proc_xfer[..., P],
    link_xfer[..., L])``, MB moved this tick per leg, process and link.

    chunk = (link.bandwidth / (background_load + campaign_load)) / n_threads,
    less the protocol overhead. All operands broadcast over leading dims.
    The sums are one-hot matmuls, as the reference's Pallas kernel takes
    them: the tests hold this against it, and no path of the port runs it
    (the per-campaign and banked ticks sum in list order,
    :func:`grid_tick_indexed` and :func:`grid_tick_bank_indexed`).
    """
    f32 = torch.float32
    a = active.to(f32)
    row = lambda v, m: torch.matmul(v.unsqueeze(-2), m).squeeze(-2)
    col = lambda v, m: torch.matmul(v.unsqueeze(-2), m.transpose(-1, -2)).squeeze(-2)
    threads = row(a, leg_proc)  # [..., P]
    proc_active = (threads > 0).to(f32)
    campaign = row(proc_active, proc_link)  # [..., L]
    denom = torch.clamp_min(campaign + torch.clamp_min(bg_load, 0.0), 1.0)
    per_proc_bw = bandwidth / denom
    per_proc_bw_leg = col(per_proc_bw, leg_link)  # [..., T]
    threads_leg = torch.clamp_min(col(threads, leg_proc), 1.0)
    chunk = a * keep_frac * per_proc_bw_leg / threads_leg
    xfer = torch.minimum(remaining, chunk)
    return xfer, row(xfer, leg_proc), row(xfer, leg_link)


def bank_split_draw(
    key: torch.Tensor, n_links: int, draw: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One background-resample draw of the banked RNG stream: split every
    (scenario, replica) key once and draw its ``[n_links]`` normals —
    ``[S, R, 2] -> ([S, R, 2] keys, [S, R, L] noise)``. The in-step draws
    of :func:`grid_tick_bank_window` and the kernel path's pre-drawn key
    chain both replay exactly this sequence. ``draw=False`` splits alone and
    returns zero noise: for a bank whose every ``sigma`` is 0 the normals
    are multiplied by 0, and the keys advance all the same."""
    pair = prng.split(key, 2)  # [S, R, 2, 2]
    sub = pair[..., 1, :]
    if not draw:
        return pair[..., 0, :], torch.zeros(
            sub.shape[:-1] + (n_links,), dtype=torch.float32, device=key.device
        )
    return pair[..., 0, :], prng.normal(sub, (n_links,))


def _check_one_hot(**incidences: torch.Tensor) -> None:
    """Raise unless every row of each incidence has at most one nonzero
    entry: the index tables keep one column per row, where a matmul would
    sum them all. All-zero (padded) rows are allowed."""
    for name, m in incidences.items():
        per_row = (m != 0).sum(dim=-1)
        if bool(torch.any(per_row > 1)):
            row = torch.nonzero(per_row > 1)[0].tolist()
            raise ValueError(
                f"{name} must be one-hot per row: row {row} has "
                f"{int(per_row[tuple(row)])} nonzero entries"
            )


def upload(x, device) -> torch.Tensor:
    """A copy of host data ``x`` (a numpy array or a CPU tensor) on
    ``device``, sharing no memory with ``x``. To a CUDA device the copy is
    staged through pinned memory and enqueued with ``non_blocking=True``:
    it waits for no work in flight on the stream, and the caching host
    allocator keeps the pinned block until the copy has run. Staging copies
    ``x`` at once, so the caller may change ``x`` as soon as this returns."""
    x = torch.as_tensor(x)
    device = torch.device(device)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device, copy=True)


def _moved(x: torch.Tensor, device) -> torch.Tensor:
    """``x.to(device)``, by :func:`upload` from the host to a CUDA device."""
    if x.device.type == "cpu" and torch.device(device).type == "cuda":
        return upload(x, device)
    return x.to(device)


class SegmentPlan(NamedTuple):
    """A batch of segment sums, ``out[s, :, c]`` the sum of ``v[s, :, m]``
    over the members ``m`` of segment ``(s, c)`` added one term at a time in
    list order from 0.0, as gathers and adds with no host sync.

    Segments are ranked longest first (``pos`` holds the rank of each flat
    segment ``s * C + c``), so step ``j`` adds the ``j``-th member of the
    first ``steps[j]`` ranked segments; ``src`` lists, step by step and in
    rank order, the flat source row ``s * X + m`` of each such member, and
    ``dst`` the rank it adds into. On the CPU one ``index_add_`` adds them
    all: it adds one row an entry, in entry order, so each segment's terms
    in list order. On the card ``index_add_`` takes atomics in no order, so
    there each step is one add."""

    src: torch.Tensor  # [nnz] i64
    dst: torch.Tensor  # [nnz] i64
    pos: torch.Tensor  # [S * C] i64
    steps: Tuple[int, ...]
    n_segments: int  # C

    def to(self, device) -> "SegmentPlan":
        """The plan on ``device`` (from the host to the card without a wait;
        ``steps`` stays a host tuple)."""
        return self._replace(src=_moved(self.src, device), dst=_moved(self.dst, device),
                             pos=_moved(self.pos, device))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """``[S, R, X] -> [S, R, C]``."""
        S, R, X = v.shape
        C = self.n_segments
        rows = v.transpose(1, 2).reshape(S * X, R).index_select(0, self.src)
        acc = v.new_zeros((S * C, R))
        if v.device.type == "cpu":
            acc.index_add_(0, self.dst, rows)
        else:
            start = 0
            for n in self.steps:
                acc[:n].add_(rows[start:start + n])
                start += n
        return acc.index_select(0, self.pos).view(S, C, R).transpose(1, 2).contiguous()


class BankTables(NamedTuple):
    """A bank's incidences as the banked kernels and the plain window read
    them.

    ``proc_of_leg``, ``link_of_leg`` and ``link_of_proc`` hold the column of
    each one-hot row (0 for an all-zero, padded row). Two segment lists,
    each a ``[S, C + 1]`` pointer row beside a member row padded with 0
    past ``ptr[s, C]``, give per scenario, in ascending order, the legs of
    each process (``proc_ptr``, ``proc_legs``) and the processes of each
    link (``link_proc_ptr``, ``link_procs``). A padded row is in no list.

    The float sums of a tick follow the lists, one term at a time from 0.0:
    a process's over its legs, a link's over its processes' sums. So a link
    that carries one process sums to exactly that process's sum.
    ``proc_sums`` and ``link_sums`` are those two sums as
    :class:`SegmentPlan` s; ``packed`` ``[S, 3T + 2P + L + 2]`` is what the
    CUDA kernels stage, ``proc_of_leg | link_of_leg | proc_ptr | proc_legs
    | link_proc_ptr | link_procs`` of each scenario."""

    proc_of_leg: torch.Tensor  # [S, T] i32
    link_of_leg: torch.Tensor  # [S, T] i32
    link_of_proc: torch.Tensor  # [S, P] i32
    proc_ptr: torch.Tensor  # [S, P + 1] i32
    proc_legs: torch.Tensor  # [S, T] i32
    link_proc_ptr: torch.Tensor  # [S, L + 1] i32
    link_procs: torch.Tensor  # [S, P] i32
    packed: torch.Tensor  # [S, 3T + 2P + L + 2] i32
    proc_sums: SegmentPlan  # legs -> processes
    link_sums: SegmentPlan  # processes -> links

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """``(S, T, P, L)``."""
        S, T = self.proc_of_leg.shape
        return (S, T, self.link_of_proc.shape[1], self.link_proc_ptr.shape[1] - 1)

    def to(self, device) -> "BankTables":
        """The tables on ``device`` (from the host to the card without a
        wait)."""
        return BankTables(*(x.to(device) if isinstance(x, SegmentPlan) else _moved(x, device)
                            for x in self))


def bank_sums(v: torch.Tensor, tables: BankTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(proc [S, R, P], link [S, R, L])`` of ``v [S, R, T]``: each
    process's sum over its legs, each link's over its processes' sums, in
    the order of the tables' lists."""
    proc = tables.proc_sums(v)
    return proc, tables.link_sums(proc)


def _segment_lists(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ptr [S, C + 1], members [S, X])`` i32 of the nonzeros of ``m [S,
    X, C]`` by column, members ascending within a column, each member row
    padded with 0 past ``ptr[s, C]``."""
    nz = (m != 0).transpose(1, 2)  # [S, C, X]
    S, C, X = nz.shape
    counts = nz.sum(dim=2)  # [S, C]
    ptr = torch.zeros((S, C + 1), dtype=torch.int64)
    ptr[:, 1:] = torch.cumsum(counts, dim=1)
    s, _, x = torch.nonzero(nz, as_tuple=True)  # by scenario, column, member
    first = torch.cumsum(ptr[:, C], 0) - ptr[:, C]  # each scenario's first nonzero
    members = torch.zeros((S, X), dtype=torch.int64)
    members[s, torch.arange(s.numel()) - first[s]] = x
    return ptr.to(torch.int32), members.to(torch.int32)


def _segment_plan(ptr: torch.Tensor, members: torch.Tensor, n_src: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of the lists ``(ptr, members)`` (as
    :func:`_segment_lists` gives them) over sources of width ``n_src``."""
    S, C = ptr.shape[0], ptr.shape[1] - 1
    ptr, members = ptr.long(), members.long()
    deg = (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)  # [S * C]
    rank = torch.sort(-deg, stable=True).indices
    pos = torch.empty_like(rank)
    pos[rank] = torch.arange(S * C)
    seg = torch.repeat_interleave(torch.arange(S * C), deg)  # each entry's segment
    j = torch.arange(seg.numel()) - torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
    s = seg // C
    m = members[s, ptr[:, :-1].reshape(-1)[seg] + j]
    by_step = torch.sort(j * (S * C) + pos[seg]).indices
    return SegmentPlan(src=(s * n_src + m)[by_step], dst=pos[seg][by_step], pos=pos,
                       steps=tuple(torch.bincount(j).tolist()), n_segments=C)


def _check_leg_links(lp: torch.Tensor, pl: torch.Tensor, ll: torch.Tensor) -> None:
    """Raise unless each leg's link is its process's link: a link's sum
    adds its processes' sums, so a leg on another link than its process's
    would be summed on the wrong one. A padded leg (no process, no link)
    passes."""
    via_proc = torch.bmm((lp != 0).float(), (pl != 0).float()) != 0  # [S, T, L]
    bad = (via_proc != (ll != 0)).any(dim=-1)
    if bool(bad.any()):
        s, leg = torch.nonzero(bad)[0].tolist()
        raise ValueError(
            f"leg {leg} of scenario {s}: its link is not its process's link "
            "(leg_link must equal leg_proc @ proc_link)"
        )


def bank_index_tables(
    leg_proc: torch.Tensor,  # [S, T, P] one-hot
    proc_link: torch.Tensor,  # [S, P, L] one-hot
    leg_link: torch.Tensor,  # [S, T, L] one-hot
) -> BankTables:
    """The :class:`BankTables` of a bank, on the incidences' device. A row
    with more than one nonzero entry raises, as does a leg whose link is
    not its process's link; all-zero (padded) rows are allowed."""
    _check_one_hot(leg_proc=leg_proc, proc_link=proc_link, leg_link=leg_link)
    lp, pl, ll = (m.detach().cpu() for m in (leg_proc, proc_link, leg_link))
    _check_leg_links(lp, pl, ll)
    T, P = lp.shape[1], lp.shape[2]
    i32 = torch.int32
    cols = [torch.argmax(lp, dim=-1).to(i32), torch.argmax(ll, dim=-1).to(i32),
            torch.argmax(pl, dim=-1).to(i32)]
    proc_ptr, proc_legs = _segment_lists(lp)
    link_proc_ptr, link_procs = _segment_lists(pl)
    packed = torch.cat(
        [cols[0], cols[1], proc_ptr, proc_legs, link_proc_ptr, link_procs], dim=1)
    return BankTables(
        *cols, proc_ptr, proc_legs, link_proc_ptr, link_procs, packed,
        _segment_plan(proc_ptr, proc_legs, T), _segment_plan(link_proc_ptr, link_procs, P),
    ).to(leg_proc.device)


def campaign_index_tables(
    leg_proc: torch.Tensor,  # [T, P] one-hot
    proc_link: torch.Tensor,  # [P, L] one-hot
    leg_link: torch.Tensor,  # [T, L] one-hot
) -> BankTables:
    """The :class:`BankTables` of one campaign, a bank of one scenario
    (``S = 1``), on the incidences' device: the per-campaign tick and sums
    walk the same lists in the same order as the bank's. Refuses what
    :func:`bank_index_tables` refuses."""
    if leg_proc.dim() != 2 or proc_link.dim() != 2 or leg_link.dim() != 2:
        raise ValueError(
            "campaign incidences must be [T, P], [P, L], [T, L]: got "
            f"{tuple(leg_proc.shape)}, {tuple(proc_link.shape)}, {tuple(leg_link.shape)}"
        )
    return bank_index_tables(leg_proc[None], proc_link[None], leg_link[None])


def grid_tick_indexed(
    active: torch.Tensor,  # [B, T] in {0, 1}
    remaining: torch.Tensor,  # [B, T] f32 MB
    keep_frac: torch.Tensor,  # [T] or [B, T]
    bg_load: torch.Tensor,  # [B, L]
    bandwidth: torch.Tensor,  # [L]
    leg_proc: torch.Tensor,  # [T, P] one-hot
    proc_link: torch.Tensor,  # [P, L] one-hot
    tables: BankTables,  # of one campaign (campaign_index_tables)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`grid_tick` for ``B`` simulations of one campaign:
    :func:`grid_tick_bank_indexed` at ``S = 1``, the ``B`` simulations its
    replicas, so every float sum runs in the order of the campaign's lists
    (the per-campaign kernel's order)."""
    out = grid_tick_bank_indexed(
        active[None], remaining[None], keep_frac[None], bg_load[None], bandwidth[None],
        leg_proc[None], proc_link[None], tables,
    )
    return tuple(x[0] for x in out)


def _to_legs(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-proc/link values back to legs: ``[S, R, X] -> [S, R, T]``;
    bitwise the one-hot matvec (one term and zeros)."""
    full = idx.long()[:, None, :].expand(v.shape[0], v.shape[1], idx.shape[-1])
    return torch.gather(v, 2, full)


def grid_tick_bank_indexed(
    active: torch.Tensor,  # [S, R, T] in {0, 1}
    remaining: torch.Tensor,  # [S, R, T] f32 MB
    keep_frac: torch.Tensor,  # [S, T], [S, 1, T] or [S, R, T]
    bg_load: torch.Tensor,  # [S, R, L]
    bandwidth: torch.Tensor,  # [S, L]
    leg_proc: torch.Tensor,  # [S, T, P] one-hot
    proc_link: torch.Tensor,  # [S, P, L] one-hot
    tables: BankTables,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`grid_tick` of a bank through its :class:`BankTables`:
    ``(xfer [S, R, T], proc_xfer [S, R, P], link_xfer [S, R, L])``, the
    float sums in the order of the tables' lists, as the CUDA kernels take
    them, so the kernels equal this bitwise. The counts (active legs per
    process, active processes per link) are exact integers in any order and
    stay one-hot products. Legs whose incidence row is all zero must be
    inactive (they gather column 0)."""
    f32 = torch.float32
    a = active.to(f32)
    threads = torch.bmm(a, leg_proc.to(f32))  # [S, R, P]
    proc_active = (threads > 0).to(f32)
    campaign = torch.bmm(proc_active, proc_link.to(f32))  # [S, R, L]
    denom = torch.clamp_min(campaign + torch.clamp_min(bg_load.to(f32), 0.0), 1.0)
    per_proc_bw = bandwidth.to(f32)[:, None, :] / denom
    keep3 = keep_frac if keep_frac.dim() == 3 else keep_frac[:, None]
    threads_leg = torch.clamp_min(_to_legs(threads, tables.proc_of_leg), 1.0)
    chunk = a * keep3.to(f32) * _to_legs(per_proc_bw, tables.link_of_leg) / threads_leg
    xfer = torch.minimum(remaining.to(f32), chunk)
    return (xfer, *bank_sums(xfer, tables))


def grid_tick_bank_window(
    state: Tuple[torch.Tensor, ...],  # see BANK_WINDOW_STATE_FIELDS
    bg_mu: torch.Tensor,  # [S, 1, L] or [S, R, L]
    bg_sigma: torch.Tensor,  # [S, 1, L] or [S, R, L]
    release: torch.Tensor,  # [S, T] i32
    dep: torch.Tensor,  # [S, T] i32 (-1 = none)
    bg_period: torch.Tensor,  # [S, L] i32
    max_ticks: torch.Tensor,  # [S] i32
    keep_frac: torch.Tensor,  # [S, T] or [S, R, T]
    bandwidth: torch.Tensor,  # [S, L]
    leg_proc: torch.Tensor,  # [S, T, P]
    proc_link: torch.Tensor,  # [S, P, L]
    leg_link: torch.Tensor,  # [S, T, L]
    *,
    leap: bool,
    tick: Optional[Tick] = None,
    key: Optional[torch.Tensor] = None,  # [S, R, 2] carried keys
    noise: Optional[torch.Tensor] = None,  # [K, S, R, L] predrawn normals
    window: Optional[int] = None,  # required with key=
    tables: Optional[BankTables] = None,
    draw: Optional[bool] = None,
    sums: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None,
):
    """``K`` simulation ticks (event leaps under ``leap``) of a whole bank,
    element for element those of ``K`` per-tick iterations under the alive
    freeze: an element is alive while its clock is below its scenario's
    ``max_ticks`` and it has unfinished legs, and aliveness masks every
    update, so a dead element's carry (key included) stays as it was.

    RNG modes (exactly one): ``key=`` splits every key once per step and
    draws in-step, returning ``(state, key)``; ``noise=`` consumes the
    pre-drawn rows and returns ``state`` (``steps`` says how far each key
    chain advanced).

    ``tick`` is the bank fair-share tick to drive, with the signature of
    ``ops.grid_tick_bank``; ``None`` runs :func:`grid_tick_bank_indexed`.
    ``sums`` takes the leap step's per-process and per-link sums of its
    last tick (``v -> (proc, link)``, as ``ops.grid_tick_bank_sums``);
    ``None`` runs :func:`bank_sums`.
    Every per-process and per-link sum, the leap step's too, runs in the
    order of the tables' lists, so the result does not depend on how a
    library would block a product (nor on the CPU's thread count).

    ``tables`` are the bank's :func:`bank_index_tables`, computed here when
    ``None``; ``draw`` says whether any ``sigma`` is positive (``key=`` mode
    then draws normals), read from ``bg_sigma`` when ``None``. A caller that
    runs many windows of one bank passes both once.
    """
    f32 = torch.float32
    i32 = torch.int32
    if (key is None) == (noise is None):
        raise ValueError(
            "grid_tick_bank_window: pass exactly one of key= (draw in-step) "
            "or noise= (predrawn rows)"
        )
    if key is not None and window is None:
        raise ValueError("grid_tick_bank_window: key= mode requires window=")
    n_links = bg_mu.shape[-1]
    if tables is None:
        tables = bank_index_tables(leg_proc, proc_link, leg_link)
    leg_from_proc = lambda v: _to_legs(v, tables.proc_of_leg)
    leg_from_link = lambda v: _to_legs(v, tables.link_of_leg)

    if tick is None:
        def tick(a, remaining, keep, bg, bandwidth_, lp, pl, _ll):
            return grid_tick_bank_indexed(a, remaining, keep, bg, bandwidth_, lp, pl, tables)
    if sums is None:
        sums = lambda v: bank_sums(v, tables)

    mt = max_ticks[:, None]
    release3 = release[:, None, :]
    period3 = bg_period[:, None, :]
    has_dep = (dep >= 0)[:, None, :]
    dep_idx = torch.clamp_min(dep, 0).long()[:, None, :]
    stochastic = bg_sigma > 0
    if key is None:
        draw = False
    elif draw is None:
        draw = bool(torch.any(stochastic))
    steps_k = window if key is not None else noise.shape[0]

    (t, steps, remaining, done, started, t_start, t_end, conth, conpr,
     bg) = state
    k = key
    for i in range(steps_k):
        alive = (t < mt) & ~torch.all(done, dim=-1)  # [S, R]
        t3 = t[:, :, None]
        if k is not None:
            nk, noise_t = bank_split_draw(k, n_links, draw=draw)
            k = torch.where(alive[:, :, None], nk, k)
        else:
            noise_t = noise[i]
        fresh = torch.clamp_min(prng.fma(bg_sigma, noise_t, bg_mu), 0.0)
        due = (t3 % period3 == 0) & alive[:, :, None]
        bg = torch.where(due, fresh, bg)

        dep_done = torch.gather(done, 2, dep_idx.expand_as(done))
        dep_ok = torch.where(has_dep, dep_done, True)
        active = ~done & (release3 <= t3) & dep_ok & alive[:, :, None]
        a = active.to(f32)

        if not leap:
            xfer, proc_xfer, link_xfer = tick(
                a, remaining, keep_frac, bg, bandwidth,
                leg_proc, proc_link, leg_link,
            )
            remaining = remaining - xfer
            newly_done = active & (remaining <= 1e-6)
            done = done | newly_done
            own_proc = leg_from_proc(proc_xfer)
            own_link = leg_from_link(link_xfer)
            conth = conth + a * (own_proc - xfer)
            conpr = conpr + a * (own_link - own_proc)
            t_start = torch.where(active & ~started, t3, t_start)
            started = started | active
            t_end = torch.where(newly_done, t3 + 1, t_end)
            adv = alive.to(i32)
        else:
            inf_rem = torch.full_like(remaining, float("inf"))
            rate, proc_rate, link_rate = tick(
                a, inf_rem, keep_frac, bg, bandwidth,
                leg_proc, proc_link, leg_link,
            )
            inf = float("inf")  # a scalar operand: no upload that would wait
            ttc = torch.where(
                active & (rate > 0),
                torch.ceil(remaining / torch.clamp_min(rate, 1e-30)),
                inf,
            )
            pending = ~done & (release3 > t3)
            t_rel = torch.where(pending, (release3 - t3).to(f32), inf)
            # sigma=0 links hold bg = max(mu, 0) from t=0 forever: their
            # resample ticks are rate no-ops and never throttle dt
            t_bg = torch.where(stochastic, (period3 - t3 % period3).to(f32), inf)
            dt = torch.minimum(
                torch.minimum(ttc.amin(dim=-1), t_rel.amin(dim=-1)),
                t_bg.amin(dim=-1),
            )  # [S, R]
            dt = torch.where(torch.isfinite(dt), torch.clamp_min(dt, 1.0), 1.0)
            dt1 = (dt - 1.0)[:, :, None]

            rem_mid = prng.fma(-(a * rate), dt1.expand_as(rate), remaining)
            xfer_f = torch.minimum(rem_mid, rate) * a
            proc_xfer_f, link_xfer_f = sums(xfer_f)
            remaining = rem_mid - xfer_f

            own_proc_rate = leg_from_proc(proc_rate)
            own_link_rate = leg_from_link(link_rate)
            own_proc_f = leg_from_proc(proc_xfer_f)
            own_link_f = leg_from_link(link_xfer_f)
            dt1b = dt1.expand_as(rate)
            conth = conth + a * prng.fma(
                own_proc_rate - rate, dt1b, own_proc_f - xfer_f
            )
            conpr = conpr + a * prng.fma(
                own_link_rate - own_proc_rate, dt1b, own_link_f - own_proc_f
            )

            newly_done = active & (remaining <= 1e-6)
            done = done | newly_done
            t_start = torch.where(active & ~started, t3, t_start)
            started = started | active
            t_end = torch.where(newly_done, t3 + dt.to(i32)[:, :, None], t_end)
            adv = dt.to(i32) * alive.to(i32)
        t = t + adv
        steps = steps + alive.to(i32)

    final = (t, steps, remaining, done, started, t_start, t_end, conth, conpr, bg)
    if key is not None:
        return final, k
    return final


# ---------------------------------------------------------------------------
# selu_mlp: the AALR classifier's forward (4 hidden SELU layers x 128)
# ---------------------------------------------------------------------------
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def selu(z: torch.Tensor) -> torch.Tensor:
    """``scale * (z if z > 0 else alpha * expm1(z))``, as ``jax.nn.selu``."""
    return SELU_SCALE * torch.where(z > 0, z, SELU_ALPHA * torch.expm1(z))


def selu_mlp(
    x: torch.Tensor,  # [N, F_in]
    weights: Tuple[torch.Tensor, ...],  # [F_i, F_i+1]
    biases: Tuple[torch.Tensor, ...],  # [F_i+1]
    *,
    return_pre: bool = False,
):
    """MLP with SELU on every layer but the last, in float32.

    Each product sums its terms in ascending input unit, a rounded multiply
    then a rounded add, and adds the bias after the sum: the CUDA kernel's
    order, so a row's result does not depend on the other rows of the call
    (a BLAS product changes its blocking with the row count). With
    ``return_pre`` it also returns the ``[depth, N, H]`` stack of hidden
    pre-activations that the backward reads."""
    h = x.to(torch.float32)
    pre = []
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        w = w.to(torch.float32)
        acc = h[:, 0:1] * w[0]
        for k in range(1, w.shape[0]):
            acc = acc + h[:, k:k + 1] * w[k]
        h = acc + b.to(torch.float32)
        if i < n - 1:
            pre.append(h)
            h = selu(h)
    if return_pre:
        return h, torch.stack(pre)
    return h


# ---------------------------------------------------------------------------
# the LLM substrate's kernels: flash attention (forward), decode attention,
# chunkwise mLSTM / SSD. Each computes in float32 and returns the dtype of
# its query, as the reference's ``repro.kernels.ref`` does.
# ---------------------------------------------------------------------------
_NEG = -1e30


def _attention_mask(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
                    device) -> torch.Tensor:
    """``[Sq, Skv]`` True where query ``i`` (at position ``i + q_offset``)
    keeps key ``j``."""
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic-form attention with GQA (query head ``h`` reads KV head
    ``h // (Hq / Hkv)``), ``causal`` masking, the sliding ``window`` band
    ``k_pos > q_pos - window`` and ``q_offset`` (absolute position of
    ``q[:, 0]``): ``(out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq]
    float32)``. ``lse`` is the log-sum-exp of the scaled scores over the
    unmasked keys, ``+inf`` on a row with none (whose ``out`` is 0), as the
    TPU kernel emits it for its backward."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qf = q.to(f32) * scale
    kf = k.to(f32).repeat_interleave(rep, dim=2)
    vf = v.to(f32).repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows (a window shorter than the gap q_offset leaves)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    return out, torch.where(torch.isneginf(lse), float("inf"), lse)


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    out: torch.Tensor,  # [B, Sq, Hq, D] forward output
    lse: torch.Tensor,  # [B, Hq, Sq] forward log-sum-exp (+inf on dead rows)
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention`'s ``out`` in the reference
    kernels' formula (``flash_attention_bwd_pallas``): ``delta = sum_d dout
    out``, ``p = exp(scale q k - lse)`` where the masks keep the pair (0
    elsewhere and on dead rows, whose ``lse`` is ``+inf``), ``ds = p (dout
    v^T - delta)``, ``dq = scale ds k``, ``dk = scale ds^T q``, ``dv = p^T
    dout``; a KV head's gradients sum its ``Hq / Hkv`` query heads. Quadratic,
    in float32; ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qf = q.to(f32) * scale
    kf = k.to(f32).repeat_interleave(rep, dim=2)
    vf = v.to(f32).repeat_interleave(rep, dim=2)
    dof = dout.to(f32)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.to(f32))
    mask = _attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    # [B, Hq, Sq, Skv] scores -> p and dp -> ds in place: two such tensors
    # live at a time
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p.sub_(lse.to(f32)[..., None]).exp_().masked_fill_(~mask, 0.0)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds.sub_(delta[..., None]).mul_(p)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_magnitudes(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    out: torch.Tensor,  # [B, Sq, Hq, D] forward output
    lse: torch.Tensor,  # [B, Hq, Sq] forward log-sum-exp (+inf on dead rows)
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scale |ds| |k|, scale |ds|^T |q|, |p|^T |dout|)`` in float32: the
    first ``[B, Sq, Hq, D]``, the other two ``[B, Skv, Hkv, D]`` summed over
    each KV head's query heads, with ``p`` and ``ds`` as
    :func:`flash_attention_bwd` forms them: the sums of magnitudes behind dq,
    dk and dv. A kernel that rounds ``ds`` or ``p`` to a type with unit
    roundoff ``u`` before those products moves each entry of dq, dk or dv by
    at most ``u`` times the entry here."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention_bwd_magnitudes: Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qf = q.to(f32) * scale
    kf = k.to(f32).repeat_interleave(rep, dim=2)
    vf = v.to(f32).repeat_interleave(rep, dim=2)
    dof = dout.to(f32)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.to(f32))
    mask = _attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p.sub_(lse.to(f32)[..., None]).exp_().masked_fill_(~mask, 0.0)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds.sub_(delta[..., None]).mul_(p).abs_()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf.abs())
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    return dq, dk.reshape(B, Skv, Hkv, rep, D).sum(3), dv.reshape(B, Skv, Hkv, rep, D).sum(3)


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D] one new token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per sequence against its KV cache (GQA), masking
    cache positions ``>= lengths[b]``: ``[B, Hq, D]`` in q's dtype (0 where
    a sequence has no valid position)."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qf = q.to(f32) * scale
    kf = k_cache.to(f32).repeat_interleave(rep, dim=2)
    vf = v_cache.to(f32).repeat_interleave(rep, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    mask = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    return torch.einsum("bhs,bshd->bhd", probs, vf).to(q.dtype)


def _mlstm_gates(i_gate, f_gate, normalize: bool):
    """``(log input gate, log forget gate)`` in float32: xLSTM's forget gate
    is a log-sigmoid, SSD's ``f_gate`` is already the log-decay."""
    fg = f_gate.to(torch.float32)
    return i_gate.to(torch.float32), F.logsigmoid(fg) if normalize else fg


def mlstm_chunk(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,  # [B, S, H, Dk]
    v: torch.Tensor,  # [B, S, H, Dv]
    i_gate: torch.Tensor,  # [B, S, H] input-gate pre-activations
    f_gate: torch.Tensor,  # [B, S, H] forget-gate pre-activations
    *,
    eps: float = 1e-6,
    normalize: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The matrix-memory cell in its fully parallel form (``O(S^2)`` memory;
    the CPU path takes it for ``S <= 256``): ``[B, S, H, Dv]`` in q's dtype.

    ``normalize=True`` is xLSTM's mLSTM (exponential input gate, sigmoid
    forget gate in log space, stabiliser ``m`` and the ``max(|.|, e^-m)``
    normaliser); ``normalize=False`` is mamba-2's SSD (``f_gate`` the raw
    log-decay, ``i_gate`` the raw log-injection, no stabiliser, no
    normaliser)."""
    B, S, H, Dk = q.shape
    if scale is None:
        scale = Dk ** -0.5 if normalize else 1.0
    f32 = torch.float32
    qf = q.to(f32) * scale
    kf, vf = k.to(f32), v.to(f32)
    logi, logf = _mlstm_gates(i_gate, f_gate, normalize)
    Fc = torch.cumsum(logf, dim=1)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]  # [B,S,S,H]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
    if normalize:
        m = torch.amax(dmat, dim=2, keepdim=True)  # [B,S,1,H]
    else:
        m = torch.zeros_like(dmat[:, :, :1, :])
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * torch.exp(dmat - m)
    out = torch.einsum("btsh,bshd->bthd", scores, vf)
    if normalize:
        norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :])) + eps
        out = out / norm[..., None]
    return out.to(q.dtype)


def mlstm_chunk_chunked(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, S, H, Dv]
    i_gate: torch.Tensor,  # [B, S, H]
    f_gate: torch.Tensor,  # [B, S, H]
    *,
    chunk: int = 128,
    eps: float = 1e-6,
    normalize: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same cell as :func:`mlstm_chunk` by the chunkwise recurrence the
    CUDA kernel runs (the reference's ``mlstm_chunk_xla``): parallel inside
    each chunk of ``chunk`` positions, the state ``C [Dk, Dv]``, ``n [Dk]``
    and ``m`` carried from chunk to chunk. ``S`` is padded to a multiple of
    ``chunk`` with ``i = -1e30`` (no contribution) and a log forget gate of
    0 (no decay)."""
    return _mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk, eps=eps,
                          normalize=normalize, scale=scale, round_to=None)


def mlstm_chunk_tc(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, S, H, Dv]
    i_gate: torch.Tensor,  # [B, S, H]
    f_gate: torch.Tensor,  # [B, S, H]
    *,
    chunk: int = 128,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The rounding model of the bf16 SSD tensor-core kernel
    (``csrc/mlstm_chunk.cu`` ``mlstm_ssd_mma_kernel``; ``normalize=False``):
    :func:`mlstm_chunk_chunked` with the three float32 operands that the
    kernel rounds to bf16 before a product rounded the same way, and
    nowhere else: the intra-chunk scores ``S_intra`` before ``S_intra V``,
    ``kw = k exp(w)`` before ``kw^T V`` and the carried state ``C`` before
    ``q C`` (``C`` itself stays float32 from chunk to chunk)."""
    return _mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk, eps=0.0,
                          normalize=False, scale=scale, round_to=torch.bfloat16)


def _mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk, eps, normalize, scale, round_to):
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if scale is None:
        scale = Dk ** -0.5 if normalize else 1.0
    f32 = torch.float32
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S

    def chunked(x, value=0.0):  # [B, S, H, *] -> [B, H, n, c, *]
        x = F.pad(x, (0, 0, 0, 0, 0, pad), value=value) if pad else x
        return x.transpose(1, 2).reshape(B, H, n_chunks, chunk, -1)

    def rnd(x):  # an operand as the kernel rounds it before a product
        return x if round_to is None else x.to(round_to).to(f32)

    qf = chunked(q.to(f32) * scale)
    kf = chunked(k.to(f32))
    vf = chunked(v.to(f32))
    logi, logf = _mlstm_gates(i_gate, f_gate, normalize)
    li = chunked(logi[..., None], _NEG)[..., 0]  # [B, H, n, c]
    lf = chunked(logf[..., None], 0.0)[..., 0]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    C = torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
    n = torch.zeros((B, H, Dk), dtype=f32, device=q.device)
    m = torch.full((B, H), _NEG if normalize else 0.0, dtype=f32, device=q.device)
    outs = []
    for c in range(n_chunks):
        qc, kc, vc, lic = qf[:, :, c], kf[:, :, c], vf[:, :, c], li[:, :, c]
        Fc = torch.cumsum(lf[:, :, c], dim=-1)  # [B, H, c]
        f_end = Fc[..., -1]
        dmat = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
        dmat = dmat.masked_fill(~causal, _NEG)
        if normalize:
            m_row = torch.maximum(dmat.amax(dim=-1), Fc + m[..., None])
        else:
            m_row = torch.zeros_like(Fc)
        s_intra = (qc @ kc.transpose(-1, -2)) * torch.exp(dmat - m_row[..., None])
        inter = torch.exp(Fc + m[..., None] - m_row)
        num = rnd(s_intra) @ vc + inter[..., None] * (qc @ rnd(C))
        if normalize:
            qn = (qc @ n[..., None])[..., 0]
            denom = s_intra.sum(-1) + inter * qn
            norm = torch.maximum(denom.abs(), torch.exp(-m_row)) + eps
            outs.append(num / norm[..., None])
        else:
            outs.append(num)
        w = f_end[..., None] - Fc + lic
        m_new = torch.maximum(m + f_end, w.amax(dim=-1)) if normalize else m
        decay = torch.exp(m + f_end - m_new)
        kw = rnd(kc * torch.exp(w - m_new[..., None])[..., None])
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = decay[..., None] * n + kw.sum(-2)
        m = m_new
    out = torch.stack(outs, dim=2).reshape(B, H, n_chunks * chunk, Dv)[:, :, :S]
    return out.transpose(1, 2).to(q.dtype)
