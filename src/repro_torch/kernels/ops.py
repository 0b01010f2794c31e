"""Dispatch of the grid-tick operations by device.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
and a CUDA tensor takes the hand-written kernel
(:mod:`repro_torch.kernels.grid_tick`); there is no other switch and no
fallback from one to the other. Validation mirrors the reference package's
``repro.kernels.ops``.

Float32 contractions of the plain version run at full precision
(``torch.backends.cuda.matmul.allow_tf32`` must stay False, its default):
the one-hot incidence products are exact only there.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

__all__ = ["grid_tick_bank", "grid_tick_bank_fused"]


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid-tick ops run on cpu or cuda tensors, got {x.device}")
    return x.device.type


def grid_tick_bank(
    active: torch.Tensor,  # [S, R, T]
    remaining: torch.Tensor,  # [S, R, T]
    keep_frac: torch.Tensor,  # [S, T] or [S, R, T]
    bg_load: torch.Tensor,  # [S, R, L]
    bandwidth: torch.Tensor,  # [S, L]
    leg_proc: torch.Tensor,  # [S, T, P]
    proc_link: torch.Tensor,  # [S, P, L]
    leg_link: torch.Tensor,  # [S, T, L]
    *,
    tables: Optional[Tuple[torch.Tensor, ...]] = None,  # ref.bank_index_tables
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scenario-bank fair-share tick with per-scenario incidences:
    ``(xfer [S, R, T], proc_xfer [S, R, P], link_xfer [S, R, L])``.

    Per-sim state must carry the replica dim; ``keep_frac`` may be bank-wide
    ``[S, T]`` or per replica ``[S, R, T]``. The kernel reads the
    incidences as ``tables``, derived from them when ``None``.
    """
    if active.dim() != 3 or remaining.dim() != 3 or bg_load.dim() != 3:
        raise ValueError(
            "grid_tick_bank: per-sim state must be [S(cenario), R(eplica), ...] "
            f"— got active {tuple(active.shape)}, remaining "
            f"{tuple(remaining.shape)}, bg_load {tuple(bg_load.shape)}"
        )
    if keep_frac.dim() not in (2, 3):
        raise ValueError(
            f"grid_tick_bank: keep_frac must be [S, T] or [S, R, T]: "
            f"{tuple(keep_frac.shape)}"
        )
    if bandwidth.dim() != 2:
        raise ValueError(
            f"grid_tick_bank: bandwidth must be [S, L]: {tuple(bandwidth.shape)}"
        )
    if leg_proc.dim() != 3 or proc_link.dim() != 3 or leg_link.dim() != 3:
        raise ValueError(
            "grid_tick_bank: incidence matrices must carry the scenario dim "
            f"([S, T, P] / [S, P, L] / [S, T, L]) — got {tuple(leg_proc.shape)}, "
            f"{tuple(proc_link.shape)}, {tuple(leg_link.shape)}"
        )
    s = active.shape[0]
    for name, arr in (
        ("remaining", remaining), ("keep_frac", keep_frac), ("bg_load", bg_load),
        ("bandwidth", bandwidth), ("leg_proc", leg_proc),
        ("proc_link", proc_link), ("leg_link", leg_link),
    ):
        if arr.shape[0] != s:
            raise ValueError(
                f"grid_tick_bank: {name} scenario dim {arr.shape[0]} != {s}"
            )
    if _device_kind(active) == "cpu":
        keep3 = keep_frac if keep_frac.dim() == 3 else keep_frac[:, None]
        return ref.grid_tick(
            active, remaining, keep3, bg_load, bandwidth[:, None],
            leg_proc[:, None], proc_link[:, None], leg_link[:, None],
        )
    from repro_torch.kernels import grid_tick as _k

    if tables is None:
        tables = ref.bank_index_tables(leg_proc, proc_link, leg_link)
    f32 = torch.float32
    return _k.grid_tick_bank_cuda(
        active.to(f32).contiguous(), remaining.to(f32).contiguous(),
        keep_frac.to(f32).contiguous(), bg_load.to(f32).contiguous(),
        bandwidth.to(f32).contiguous(), *tables,
    )


def _bank_noise_chain(
    n_links: int, key: torch.Tensor, window: int, draw: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-draw one window of background noise for the fused kernel:
    ``window`` replays of :func:`ref.bank_split_draw`, as ``noise [K, S, R,
    L]`` plus the key chain ``[K + 1, S, R, 2]`` (entry ``j`` is the key
    after ``j`` splits, so an element that ran ``j`` alive ticks resumes from
    ``chain[j]``). ``draw=False`` splits the keys and leaves the noise zero,
    for a bank whose every ``sigma`` is 0 (``sigma * noise`` is then 0)."""
    keys = [key]
    rows = []
    for _ in range(window):
        key, noise = ref.bank_split_draw(key, n_links, draw=draw)
        keys.append(key)
        rows.append(noise)
    return torch.stack(keys), torch.stack(rows)


def grid_tick_bank_fused(
    state: Tuple[torch.Tensor, ...],  # ref.BANK_WINDOW_STATE_FIELDS layout
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
    window: int,
    leap: bool = False,
    key: Optional[torch.Tensor] = None,  # [S, R, 2] carried keys
    noise: Optional[torch.Tensor] = None,  # [K, S, R, L] predrawn normals
    tables: Optional[Tuple[torch.Tensor, ...]] = None,  # ref.bank_index_tables
    draw: Optional[bool] = None,  # any bg_sigma > 0 (key= mode)
):
    """``window`` fused simulation ticks (event leaps under ``leap``) of a
    scenario bank; ``state`` follows ``ref.BANK_WINDOW_STATE_FIELDS``.

    With ``key=`` the keys ride along and ``(state, key)`` returns; with
    ``noise=`` the pre-drawn rows are consumed and ``state`` returns.

    On CPU tensors this is the plain scan with its index-based tick. On CUDA
    tensors, tick mode is one launch of the fused kernel (the key chain and
    its noise drawn ahead, each element's key then resynchronised from its
    alive-step count); leap mode is the plain scan driving the one-tick
    kernel once per event step, as the reference's kernel path does.

    ``tables`` (the incidences as index tables) and ``draw`` (whether any
    ``sigma`` is positive) are fixed for a bank: a caller that runs many
    windows passes them, else they are derived here on every call.
    """
    if len(state) != len(ref.BANK_WINDOW_STATE_FIELDS):
        raise ValueError(
            f"grid_tick_bank_fused: state must carry "
            f"{len(ref.BANK_WINDOW_STATE_FIELDS)} arrays "
            f"({', '.join(ref.BANK_WINDOW_STATE_FIELDS)}): got {len(state)}"
        )
    if window < 1:
        raise ValueError(f"grid_tick_bank_fused: window must be >= 1: {window}")
    if (key is None) == (noise is None):
        raise ValueError(
            "grid_tick_bank_fused: pass exactly one of key= or noise="
        )
    if noise is not None and (noise.dim() != 4 or noise.shape[0] != window):
        raise ValueError(
            f"grid_tick_bank_fused: noise must be [window={window}, S, R, L]: "
            f"{tuple(noise.shape)}"
        )
    if bg_mu.dim() != 3 or bg_sigma.dim() != 3:
        raise ValueError(
            "grid_tick_bank_fused: bg moments must be [S, 1, L] or "
            f"[S, R, L]: {tuple(bg_mu.shape)}, {tuple(bg_sigma.shape)}"
        )
    if tables is None:
        tables = ref.bank_index_tables(leg_proc, proc_link, leg_link)
    if key is not None and draw is None:
        draw = bool(torch.any(bg_sigma > 0))
    on_cpu = _device_kind(state[2]) == "cpu"
    if on_cpu or leap:
        tick = None if on_cpu else functools.partial(grid_tick_bank, tables=tables)
        return ref.grid_tick_bank_window(
            state, bg_mu, bg_sigma, release, dep, bg_period, max_ticks,
            keep_frac, bandwidth, leg_proc, proc_link, leg_link,
            leap=leap, tick=tick, key=key, noise=noise, window=window,
            tables=tables, draw=draw,
        )
    from repro_torch.kernels import grid_tick as _k

    S, R = state[0].shape
    L = bg_mu.shape[-1]
    chain = None
    if key is not None:
        chain, noise = _bank_noise_chain(L, key, window, draw=draw)
    # mu and sigma agree on their replica dim inside the kernel: if either
    # carries one, broadcast both
    if bg_mu.shape[1] != 1 or bg_sigma.shape[1] != 1:
        bg_mu = bg_mu.expand(S, R, L)
        bg_sigma = bg_sigma.expand(S, R, L)
    f32, i32 = torch.float32, torch.int32
    c = lambda x, dt: x.to(dt).contiguous()
    state = tuple(
        c(x, dt) for x, dt in zip(state, (i32, i32, f32, torch.bool, torch.bool,
                                          i32, i32, f32, f32, f32))
    )
    out = _k.grid_tick_bank_fused_cuda(
        state, c(noise, f32), c(bg_mu, f32), c(bg_sigma, f32),
        c(release, i32), c(dep, i32), c(bg_period, i32), c(max_ticks, i32),
        c(keep_frac, f32), c(bandwidth, f32), *tables,
    )
    if chain is None:
        return out
    steps = out[1].long()
    key = torch.gather(chain, 0, steps[None, :, :, None].expand(1, S, R, 2))[0]
    return out, key
