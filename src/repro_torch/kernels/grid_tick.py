"""Wrappers of the hand-written CUDA grid-tick kernels (``csrc/grid_tick.cu``).

- :func:`grid_tick_bank_cuda` — one fair-share tick of a scenario bank
  (replaces the reference's ``grid_tick_bank_pallas``);
- :func:`grid_tick_bank_fused_cuda` — ``K`` ticks of a scenario bank per
  launch, the carry resident on chip (replaces
  ``grid_tick_bank_fused_pallas``).

Each wrapper takes CUDA tensors only, checks their device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream and raises if the launch is refused. :data:`LAUNCHES` counts
the launches of each kernel. The kernels take the one-hot incidences as
index tables (``ref.bank_index_tables``); the plain versions of both live in
:mod:`repro_torch.kernels.ref`, and :mod:`repro_torch.kernels.ops`
dispatches between them by device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "limits",
    "grid_tick_bank_cuda",
    "grid_tick_bank_fused_cuda",
]

#: Launch counts per kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {"grid_tick_bank": 0, "grid_tick_bank_fused": 0}

_WARPS_PER_BLOCK = 4
_MAX_GRID_Y = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_FUSED_ARGTYPES = [_P] * 13 + [_I] + [_P] * 5 + [_I] + [_P] * 14 + [_I] * 6 + [_P]
_TICK_ARGTYPES = [_P] * 3 + [_I] + [_P] * 8 + [_I] * 5 + [_P]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("grid_tick")
    if not getattr(lib, "_repro_bound", False):
        lib.grid_tick_bank_fused_launch.argtypes = _FUSED_ARGTYPES
        lib.grid_tick_bank_fused_launch.restype = _I
        lib.grid_tick_bank_launch.argtypes = _TICK_ARGTYPES
        lib.grid_tick_bank_launch.restype = _I
        lib.grid_tick_limits.argtypes = [ctypes.POINTER(_I)] * 3
        lib.grid_tick_limits.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int, int]:
    """The kernels' largest ``(legs, processes, links)`` per scenario."""
    t, p, l = _I(), _I(), _I()
    _lib().grid_tick_limits(ctypes.byref(t), ctypes.byref(p), ctypes.byref(l))
    return t.value, p.value, l.value


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> int:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def _check_dims(S: int, R: int, T: int, P: int, L: int) -> None:
    max_t, max_p, max_l = limits()
    if T > max_t or P > max_p or L > max_l:
        raise ValueError(
            f"grid-tick kernels take at most {max_t} legs, {max_p} processes "
            f"and {max_l} links per scenario: got T={T}, P={P}, L={L}"
        )
    if -(-R // _WARPS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"too many replicas for one launch: R={R}")


def _replica_stride(name: str, x: torch.Tensor, S: int, R: int, W: int) -> int:
    """``W`` when ``x`` is per replica ``[S, R, W]``, ``0`` when it is
    bank-wide ``[S, 1, W]`` or ``[S, W]``."""
    if x.dim() == 3 and x.shape[1] == R and R != 1:
        _check(name, x, torch.float32, (S, R, W))
        return W
    _check(name, x, torch.float32, (S, 1, W) if x.dim() == 3 else (S, W))
    return 0


def grid_tick_bank_cuda(
    active: torch.Tensor,  # [S, R, T] f32 0/1
    remaining: torch.Tensor,  # [S, R, T] f32
    keep_frac: torch.Tensor,  # [S, T], [S, 1, T] or [S, R, T] f32
    bg_load: torch.Tensor,  # [S, R, L] f32
    bandwidth: torch.Tensor,  # [S, L] f32
    proc_of_leg: torch.Tensor,  # [S, T] i32
    link_of_leg: torch.Tensor,  # [S, T] i32
    link_of_proc: torch.Tensor,  # [S, P] i32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fair-share tick of a bank on the card: ``(xfer [S, R, T],
    proc_xfer [S, R, P], link_xfer [S, R, L])``."""
    S, R, T = active.shape
    L = bandwidth.shape[-1]
    P = link_of_proc.shape[-1]
    ptrs = [
        _check("active", active, torch.float32, (S, R, T)),
        _check("remaining", remaining, torch.float32, (S, R, T)),
        keep_frac.data_ptr(),
    ]
    keep_rs = _replica_stride("keep_frac", keep_frac, S, R, T)
    ptrs2 = [
        _check("bg_load", bg_load, torch.float32, (S, R, L)),
        _check("bandwidth", bandwidth, torch.float32, (S, L)),
        _check("proc_of_leg", proc_of_leg, torch.int32, (S, T)),
        _check("link_of_leg", link_of_leg, torch.int32, (S, T)),
        _check("link_of_proc", link_of_proc, torch.int32, (S, P)),
    ]
    _check_dims(S, R, T, P, L)
    dev = active.device
    xfer = torch.empty((S, R, T), dtype=torch.float32, device=dev)
    proc_xfer = torch.empty((S, R, P), dtype=torch.float32, device=dev)
    link_xfer = torch.empty((S, R, L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().grid_tick_bank_launch(
        *ptrs, keep_rs, *ptrs2,
        xfer.data_ptr(), proc_xfer.data_ptr(), link_xfer.data_ptr(),
        S, R, T, P, L, stream,
    )
    if err != 0:
        raise RuntimeError(f"grid_tick_bank kernel launch failed: cudaError_t {err}")
    LAUNCHES["grid_tick_bank"] += 1
    return xfer, proc_xfer, link_xfer


_STATE_DTYPES = (
    ("t", torch.int32, 2), ("steps", torch.int32, 2),
    ("remaining", torch.float32, 3), ("done", torch.bool, 3),
    ("started", torch.bool, 3), ("t_start", torch.int32, 3),
    ("t_end", torch.int32, 3), ("conth", torch.float32, 3),
    ("conpr", torch.float32, 3), ("bg", torch.float32, -1),
)


def grid_tick_bank_fused_cuda(
    state: Tuple[torch.Tensor, ...],  # ref.BANK_WINDOW_STATE_FIELDS layout
    noise: torch.Tensor,  # [K, S, R, L] f32
    bg_mu: torch.Tensor,  # [S, 1, L] or [S, R, L] f32
    bg_sigma: torch.Tensor,  # [S, 1, L] or [S, R, L] f32
    release: torch.Tensor,  # [S, T] i32
    dep: torch.Tensor,  # [S, T] i32
    bg_period: torch.Tensor,  # [S, L] i32
    max_ticks: torch.Tensor,  # [S] i32
    keep_frac: torch.Tensor,  # [S, T] or [S, R, T] f32
    bandwidth: torch.Tensor,  # [S, L] f32
    proc_of_leg: torch.Tensor,  # [S, T] i32
    link_of_leg: torch.Tensor,  # [S, T] i32
    link_of_proc: torch.Tensor,  # [S, P] i32
) -> Tuple[torch.Tensor, ...]:
    """``K = noise.shape[0]`` fair-share ticks of a bank in one launch; the
    returned carry follows ``ref.BANK_WINDOW_STATE_FIELDS``. ``bg_mu`` and
    ``bg_sigma`` must agree on their replica dim (``ops`` broadcasts a mixed
    pair)."""
    K, S, R, L = noise.shape
    T = state[2].shape[-1]
    P = link_of_proc.shape[-1]
    shapes = {2: (S, R), 3: (S, R, T), -1: (S, R, L)}
    carry = [
        _check(name, x, dt, shapes[rank])
        for (name, dt, rank), x in zip(_STATE_DTYPES, state)
    ]
    bg_rs = _replica_stride("bg_mu", bg_mu, S, R, L)
    if _replica_stride("bg_sigma", bg_sigma, S, R, L) != bg_rs:
        raise ValueError("bg_mu and bg_sigma must agree on their replica dim")
    keep_rs = _replica_stride("keep_frac", keep_frac, S, R, T)
    consts = [
        _check("release", release, torch.int32, (S, T)),
        _check("dep", dep, torch.int32, (S, T)),
        _check("bg_period", bg_period, torch.int32, (S, L)),
        _check("max_ticks", max_ticks, torch.int32, (S,)),
    ]
    tables = [
        _check("bandwidth", bandwidth, torch.float32, (S, L)),
        _check("proc_of_leg", proc_of_leg, torch.int32, (S, T)),
        _check("link_of_leg", link_of_leg, torch.int32, (S, T)),
        _check("link_of_proc", link_of_proc, torch.int32, (S, P)),
    ]
    _check_dims(S, R, T, P, L)
    dev = noise.device
    out = tuple(
        torch.empty(shapes[rank], dtype=dt, device=dev)
        for _, dt, rank in _STATE_DTYPES
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().grid_tick_bank_fused_launch(
        *carry,
        _check("noise", noise, torch.float32, (K, S, R, L)),
        bg_mu.data_ptr(), bg_sigma.data_ptr(), bg_rs,
        *consts, keep_frac.data_ptr(), keep_rs, *tables,
        *(o.data_ptr() for o in out),
        S, R, T, P, L, K, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grid_tick_bank_fused kernel launch failed: cudaError_t {err}"
        )
    LAUNCHES["grid_tick_bank_fused"] += 1
    return out
