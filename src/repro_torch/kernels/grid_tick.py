"""Wrappers of the hand-written CUDA grid-tick kernels (``csrc/grid_tick.cu``).

- :func:`grid_tick_bank_fused_cuda` — ``K`` ticks of a scenario bank per
  launch, the carry resident on chip (replaces
  ``grid_tick_bank_fused_pallas``);
- :func:`grid_tick_bank_cuda` — one fair-share tick of a scenario bank
  (replaces the reference's ``grid_tick_bank_pallas``);
- :func:`grid_tick_cuda` — one fair-share tick of ``B`` simulations of one
  campaign (replaces the reference's ``grid_tick_pallas``): the same tick
  kernel, on the campaign as a bank of one scenario whose ``B``
  simulations are its replicas;
- :func:`grid_tick_bank_sums_cuda`, :func:`grid_tick_sums_cuda` — the
  per-process and per-link sums of a per-leg tensor of a bank or of one
  campaign, as the leap steps take them (the reference takes them as
  one-hot dots, not as a Pallas kernel).

Each wrapper takes CUDA tensors only, checks their device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream and raises if the launch is refused. :data:`LAUNCHES` counts
the launches of each wrapper. The kernels take the one-hot incidences as
the segment lists of ``ref.BankTables`` (``ref.bank_index_tables``, or
``ref.campaign_index_tables`` for one campaign), packed into one int32
buffer; past the bank limits (:func:`limits`) each kernel runs an instance
with the tables in dynamic shared memory, up to :func:`campaign_limits`,
which every wrapper takes; a bank wrapper counts those launches under its
name with ``_wide`` appended. The plain
versions live in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` dispatches between them by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import BankTables

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "limits",
    "bank_occupancy",
    "wide_occupancy",
    "campaign_limits",
    "grid_tick_cuda",
    "grid_tick_sums_cuda",
    "grid_tick_bank_cuda",
    "grid_tick_bank_fused_cuda",
    "grid_tick_bank_sums_cuda",
]

#: Launch counts per wrapper, raised by one at every launch.
LAUNCHES: Dict[str, int] = {
    "grid_tick": 0, "grid_tick_sums": 0, "grid_tick_bank": 0, "grid_tick_bank_fused": 0,
    "grid_tick_bank_sums": 0, "grid_tick_bank_wide": 0, "grid_tick_bank_fused_wide": 0,
    "grid_tick_bank_sums_wide": 0,
}

_WARPS_PER_BLOCK = 4
_MAX_GRID_Y = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_FUSED_ARGTYPES = [_P] * 13 + [_I] + [_P] * 5 + [_I] + [_P] * 12 + [_I] * 6 + [_P]
_TICK_ARGTYPES = [_P] * 3 + [_I] + [_P] * 6 + [_I] * 5 + [_P]
_SUMS_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]


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
        lib.grid_tick_bank_sums_launch.argtypes = _SUMS_ARGTYPES
        lib.grid_tick_bank_sums_launch.restype = _I
        for fn in (lib.grid_tick_limits, lib.grid_tick_campaign_limits):
            fn.argtypes = [ctypes.POINTER(_I)] * 3
            fn.restype = _I
        lib.grid_tick_bank_occupancy.argtypes = [_I] + [ctypes.POINTER(_I)] * 3
        lib.grid_tick_bank_occupancy.restype = _I
        lib.grid_tick_wide_occupancy.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 6
        lib.grid_tick_wide_occupancy.restype = _I
        lib._repro_bound = True
    return lib


def _limits(fn) -> Tuple[int, int, int]:
    t, p, l = _I(), _I(), _I()
    fn(ctypes.byref(t), ctypes.byref(p), ctypes.byref(l))
    return t.value, p.value, l.value


@functools.lru_cache(maxsize=None)
def limits() -> Tuple[int, int, int]:
    """The bank kernels' largest ``(legs, processes, links)`` per scenario."""
    return _limits(_lib().grid_tick_limits)


def bank_occupancy() -> Dict[str, object]:
    """Blocks of each bank kernel resident on one SM of the current card, by
    the legs a scenario pads to (the kernels are built for 1-4 slots of 32
    legs a lane), and the warps (elements) a block holds."""
    out: Dict[str, object] = {"fused": {}, "tick": {}}
    for legs in (32, 64, 96, 128):
        fused, tick, warps = _I(), _I(), _I()
        err = _lib().grid_tick_bank_occupancy(
            legs, ctypes.byref(fused), ctypes.byref(tick), ctypes.byref(warps))
        if err != 0:
            raise RuntimeError(f"grid_tick_bank_occupancy failed: cudaError_t {err}")
        out["fused"][f"T<={legs}"] = fused.value
        out["tick"][f"T<={legs}"] = tick.value
        out["warps_per_block"] = warps.value
    return out


def wide_occupancy(T: int, P: int, L: int) -> Dict[str, int]:
    """The wide instances at a scenario's pads on the current card: the
    fused kernel's instance (its leg and link slots a lane), dynamic shared
    memory (bytes) and blocks resident on one SM, and the one-tick
    kernel's shared memory and blocks."""
    out = [_I() for _ in range(6)]
    err = _lib().grid_tick_wide_occupancy(T, P, L, *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"grid_tick_wide_occupancy failed: cudaError_t {err}")
    keys = ("fused_slots", "fused_link_slots", "fused_smem", "fused_blocks_per_sm", "tick_smem",
            "tick_blocks_per_sm")
    return {k: x.value for k, x in zip(keys, out)}


@functools.lru_cache(maxsize=None)
def campaign_limits() -> Tuple[int, int, int]:
    """The largest ``(legs, processes, links)`` of a scenario (or one
    campaign) that the kernels take (past :func:`limits`, by their
    instances with the tables in dynamic shared memory)."""
    return _limits(_lib().grid_tick_campaign_limits)


def _wide(T: int, P: int, L: int) -> bool:
    """Whether a scenario of these pads runs the wide instances."""
    max_t, max_p, max_l = limits()
    return T > max_t or P > max_p or L > max_l


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


def _check_tables(tables: BankTables, S: int, T: int, P: int, L: int) -> int:
    if tables.shape != (S, T, P, L):
        raise ValueError(f"tables are for (S, T, P, L) = {tables.shape}, got {(S, T, P, L)}")
    return _check("tables", tables.packed, torch.int32, (S, 3 * T + 2 * P + L + 2))


def _check_dims(S: int, R: int, T: int, P: int, L: int) -> None:
    max_t, max_p, max_l = campaign_limits()
    if T > max_t or P > max_p or L > max_l:
        raise ValueError(
            f"grid-tick kernels take at most {max_t} legs, {max_p} processes "
            f"and {max_l} links a scenario: got T={T}, P={P}, L={L}"
        )
    if -(-R // _WARPS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"too many replicas (simulations) for one launch: R={R}")


def _replica_stride(name: str, x: torch.Tensor, S: int, R: int, W: int) -> int:
    """``W`` when ``x`` is per replica ``[S, R, W]``, ``0`` when it is
    bank-wide ``[S, 1, W]`` or ``[S, W]``."""
    if x.dim() == 3 and x.shape[1] == R and R != 1:
        _check(name, x, torch.float32, (S, R, W))
        return W
    _check(name, x, torch.float32, (S, 1, W) if x.dim() == 3 else (S, W))
    return 0


def _counted(name: str, campaign: bool, T: int, P: int, L: int) -> str:
    """The :data:`LAUNCHES` key of a launch: a bank wrapper's wide launches
    count apart."""
    return name + "_wide" if not campaign and _wide(T, P, L) else name


def _tick(name: str, S: int, R: int, active, remaining, keep_frac, keep_rs: int, bg_load,
          bandwidth, tables, campaign: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the tick kernel on ``S`` scenarios x ``R`` replicas.
    The per-element tensors are shaped ``lead + (X,)``, ``lead`` being
    ``(S, R)`` for a bank and ``(B,)`` for one campaign (``S = 1``), and
    the outputs likewise; the caller has checked ``keep_frac`` (replica
    stride ``keep_rs``)."""
    lead = tuple(active.shape[:-1])
    T = active.shape[-1]
    L = bandwidth.shape[-1]
    P = tables.link_of_proc.shape[-1]
    ptrs = [
        _check("active", active, torch.float32, lead + (T,)),
        _check("remaining", remaining, torch.float32, lead + (T,)),
        keep_frac.data_ptr(), keep_rs,
        _check("bg_load", bg_load, torch.float32, lead + (L,)),
        _check("bandwidth", bandwidth, torch.float32, lead[:-1] + (L,)),
        _check_tables(tables, S, T, P, L),
    ]
    _check_dims(S, R, T, P, L)
    dev = active.device
    out = [torch.empty(lead + (n,), dtype=torch.float32, device=dev) for n in (T, P, L)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().grid_tick_bank_launch(*ptrs, *(o.data_ptr() for o in out), S, R, T, P, L, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[_counted(name, campaign, T, P, L)] += 1
    return tuple(out)


def _sums(name: str, S: int, R: int, v: torch.Tensor, tables: BankTables,
          campaign: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the sums kernel on ``v`` shaped ``lead + (T,)`` (as
    :func:`_tick`'s tensors)."""
    lead = tuple(v.shape[:-1])
    T = v.shape[-1]
    P = tables.link_of_proc.shape[-1]
    L = tables.link_proc_ptr.shape[-1] - 1
    ptrs = [_check("v", v, torch.float32, lead + (T,)), _check_tables(tables, S, T, P, L)]
    _check_dims(S, R, T, P, L)
    proc = torch.empty(lead + (P,), dtype=torch.float32, device=v.device)
    link = torch.empty(lead + (L,), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = _lib().grid_tick_bank_sums_launch(
        *ptrs, proc.data_ptr(), link.data_ptr(), S, R, T, P, L, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[_counted(name, campaign, T, P, L)] += 1
    return proc, link


def grid_tick_cuda(
    active: torch.Tensor,  # [B, T] f32 0/1
    remaining: torch.Tensor,  # [B, T] f32
    keep_frac: torch.Tensor,  # [T] or [B, T] f32
    bg_load: torch.Tensor,  # [B, L] f32
    bandwidth: torch.Tensor,  # [L] f32
    tables: BankTables,  # of one campaign (S = 1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fair-share tick of ``B`` simulations of one campaign on the
    card: ``(xfer [B, T], proc_xfer [B, P], link_xfer [B, L])``, the tick
    kernel at ``S = 1`` with the simulations as replicas."""
    if active.dim() != 2:
        raise ValueError(f"active must be [B, T], got {tuple(active.shape)}")
    B, T = active.shape
    per_row = keep_frac.dim() == 2
    _check("keep_frac", keep_frac, torch.float32, (B, T) if per_row else (T,))
    return _tick("grid_tick", 1, B, active, remaining, keep_frac, T if per_row else 0, bg_load,
                 bandwidth, tables, campaign=True)


def grid_tick_sums_cuda(
    v: torch.Tensor,  # [B, T] f32
    tables: BankTables,  # of one campaign (S = 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(proc [B, P], link [B, L])`` of ``B`` per-leg rows of one
    campaign, in the order of its lists: the sums kernel at ``S = 1``."""
    if v.dim() != 2:
        raise ValueError(f"v must be [B, T], got {tuple(v.shape)}")
    return _sums("grid_tick_sums", 1, v.shape[0], v, tables, campaign=True)


def grid_tick_bank_cuda(
    active: torch.Tensor,  # [S, R, T] f32 0/1
    remaining: torch.Tensor,  # [S, R, T] f32
    keep_frac: torch.Tensor,  # [S, T], [S, 1, T] or [S, R, T] f32
    bg_load: torch.Tensor,  # [S, R, L] f32
    bandwidth: torch.Tensor,  # [S, L] f32
    tables: BankTables,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fair-share tick of a bank on the card: ``(xfer [S, R, T],
    proc_xfer [S, R, P], link_xfer [S, R, L])``."""
    if active.dim() != 3:
        raise ValueError(f"active must be [S, R, T], got {tuple(active.shape)}")
    S, R, T = active.shape
    keep_rs = _replica_stride("keep_frac", keep_frac, S, R, T)
    return _tick("grid_tick_bank", S, R, active, remaining, keep_frac, keep_rs, bg_load,
                 bandwidth, tables, campaign=False)


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
    tables: BankTables,
) -> Tuple[torch.Tensor, ...]:
    """``K = noise.shape[0]`` fair-share ticks of a bank in one launch; the
    returned carry follows ``ref.BANK_WINDOW_STATE_FIELDS``. ``bg_mu`` and
    ``bg_sigma`` must agree on their replica dim (``ops`` broadcasts a mixed
    pair). Past :func:`limits` the launch runs ``bank_fused_wide_kernel``."""
    K, S, R, L = noise.shape
    T = state[2].shape[-1]
    P = tables.link_of_proc.shape[-1]
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
    table_ptrs = [
        _check("bandwidth", bandwidth, torch.float32, (S, L)),
        _check_tables(tables, S, T, P, L),
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
        *consts, keep_frac.data_ptr(), keep_rs, *table_ptrs,
        *(o.data_ptr() for o in out),
        S, R, T, P, L, K, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grid_tick_bank_fused kernel launch failed: cudaError_t {err}"
        )
    LAUNCHES[_counted("grid_tick_bank_fused", False, T, P, L)] += 1
    return out


def grid_tick_bank_sums_cuda(
    v: torch.Tensor,  # [S, R, T] f32
    tables: BankTables,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(proc [S, R, P], link [S, R, L])``: each process's sum of ``v`` over
    its legs and each link's over its processes' sums, in the order of the
    tables' lists, in one launch."""
    if v.dim() != 3:
        raise ValueError(f"v must be [S, R, T], got {tuple(v.shape)}")
    return _sums("grid_tick_bank_sums", v.shape[0], v.shape[1], v, tables, campaign=False)
