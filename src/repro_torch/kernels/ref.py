"""Plain PyTorch versions of the grid-tick kernels.

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

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import prng

__all__ = [
    "BANK_WINDOW_STATE_FIELDS",
    "grid_tick",
    "bank_split_draw",
    "bank_index_tables",
    "grid_tick_bank_window",
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


def bank_index_tables(
    leg_proc: torch.Tensor,  # [S, T, P] one-hot
    proc_link: torch.Tensor,  # [S, P, L] one-hot
    leg_link: torch.Tensor,  # [S, T, L] one-hot
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(proc_of_leg [S, T], link_of_leg [S, T], link_of_proc [S, P])``
    int32: the column of each one-hot row. An all-zero (padded) row maps to
    0; every quantity gathered through it is multiplied by an inactive 0."""
    i32 = torch.int32
    return (
        torch.argmax(leg_proc, dim=-1).to(i32),
        torch.argmax(leg_link, dim=-1).to(i32),
        torch.argmax(proc_link, dim=-1).to(i32),
    )


def _to_legs(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-proc/link values back to legs: ``[S, R, X] -> [S, R, T]``;
    bitwise the one-hot matvec (one term and zeros)."""
    full = idx.long()[:, None, :].expand(v.shape[0], v.shape[1], idx.shape[-1])
    return torch.gather(v, 2, full)


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
    tables: Optional[Tuple[torch.Tensor, ...]] = None,  # bank_index_tables
    draw: Optional[bool] = None,
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
    ``ops.grid_tick_bank``; ``None`` runs the built-in index-based tick (the
    one-hot gathers as index gathers, bitwise equal).

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
    n_procs = leg_proc.shape[-1]
    if tables is None:
        tables = bank_index_tables(leg_proc, proc_link, leg_link)
    proc_of_leg, link_of_leg, _ = tables
    m_cat = torch.cat([leg_proc, leg_link], dim=-1).to(f32)  # [S, T, P + L]
    keep3 = keep_frac if keep_frac.dim() == 3 else keep_frac[:, None]
    leg_from_proc = lambda v: _to_legs(v, proc_of_leg)
    leg_from_link = lambda v: _to_legs(v, link_of_leg)

    def scatter_pl(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-process and per-link sums of a per-leg quantity, as one
        batched matmul against the concatenated one-hot incidences."""
        both = torch.bmm(v, m_cat)
        return both[..., :n_procs], both[..., n_procs:]

    if tick is None:
        def tick(a, remaining, _keep, bg, bandwidth_, lp, pl, _ll):
            threads = torch.bmm(a, lp)
            proc_active = (threads > 0).to(f32)
            campaign = torch.bmm(proc_active, pl)
            denom = torch.clamp_min(campaign + torch.clamp_min(bg, 0.0), 1.0)
            per_proc_bw = bandwidth_[:, None, :] / denom
            threads_leg = torch.clamp_min(leg_from_proc(threads), 1.0)
            chunk = a * keep3 * leg_from_link(per_proc_bw) / threads_leg
            xfer = torch.minimum(remaining, chunk)
            proc_xfer, link_xfer = scatter_pl(xfer)
            return xfer, proc_xfer, link_xfer

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
            inf = torch.tensor(float("inf"), dtype=f32, device=rate.device)
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
            proc_xfer_f, link_xfer_f = scatter_pl(xfer_f)
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
