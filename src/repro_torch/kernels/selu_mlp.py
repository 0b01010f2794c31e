"""Wrapper of the hand-written CUDA SELU-MLP kernel (``csrc/selu_mlp.cu``).

:func:`selu_mlp_cuda` runs the AALR classifier's forward in one launch
(replaces the reference's ``selu_mlp_pallas``): ``depth`` SELU layers of
width ``hidden`` and a linear head, in float32, optionally writing the
hidden layers' pre-activations for the backward. It takes CUDA tensors only,
checks their device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream and raises if the launch is
refused. :data:`LAUNCHES` counts its launches. The plain version lives in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` dispatches
between them by device.

A block of the kernel owns ``row_groups x rows_per_thread`` rows (the
tile); the launch picks it from N, the widths and the card's SM count, and
:func:`tile` reports its choice. The tile changes no bit of the result:
every output is one ascending sum.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "reset_launches", "limits", "tile", "selu_mlp_cuda"]

#: Launch count of the kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {"selu_mlp": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["selu_mlp"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("selu_mlp")
    if not getattr(lib, "_repro_bound", False):
        lib.selu_mlp_launch.argtypes = [_P, _P, _P, _P, _P] + [_I] * 5 + [_P]
        lib.selu_mlp_launch.restype = _I
        lib.selu_mlp_tile.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 2
        lib.selu_mlp_tile.restype = _I
        lib.selu_mlp_limits.argtypes = [ctypes.POINTER(_I)] * 4
        lib.selu_mlp_limits.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int, int, int]:
    """The kernel's largest ``(hidden, f_in, f_out, depth)``; ``hidden``
    must also be a multiple of 32."""
    vals = [_I() for _ in range(4)]
    _lib().selu_mlp_limits(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def tile(n: int, f_in: int, hidden: int) -> Tuple[int, int]:
    """The tile ``(row_groups, rows_per_thread)`` that the kernel takes for
    ``n`` rows of ``f_in`` inputs and hidden width ``hidden`` on the current
    device: the largest that still gives every SM a block, else the
    smallest."""
    rg, rpt = _I(), _I()
    err = _lib().selu_mlp_tile(n, f_in, hidden, ctypes.byref(rg), ctypes.byref(rpt))
    if err != 0:
        raise ValueError(f"selu_mlp kernel takes no N={n}, F_in={f_in}, hidden={hidden}")
    return rg.value, rpt.value


def _check(name: str, x: torch.Tensor, shape: Tuple[int, ...]) -> int:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def selu_mlp_cuda(
    x: torch.Tensor,  # [N, F_in] f32
    weights: Sequence[torch.Tensor],  # [F_in, H], [H, H] x (depth - 1), [H, f_out]
    biases: Sequence[torch.Tensor],  # [H] x depth, [f_out]
    *,
    save_pre: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MLP forward on the card: ``(out [N, f_out], pre)`` where ``pre``
    is the ``[depth, N, H]`` stack of hidden pre-activations when
    ``save_pre``, else ``None``."""
    if len(weights) != len(biases) or len(weights) < 2:
        raise ValueError(
            f"selu_mlp needs depth + 1 >= 2 weights and as many biases: "
            f"{len(weights)} weights, {len(biases)} biases"
        )
    n, f_in = x.shape
    depth = len(weights) - 1
    hidden = weights[0].shape[1]
    f_out = weights[-1].shape[1]
    max_h, max_in, max_out, max_depth = limits()
    if (hidden % 32 or not 32 <= hidden <= max_h or not 1 <= f_in <= max_in
            or not 1 <= f_out <= max_out or depth > max_depth or n < 1):
        raise ValueError(
            f"selu_mlp kernel takes hidden widths 32..{max_h} in steps of 32, "
            f"inputs up to {max_in}, heads up to {max_out} wide and depth up "
            f"to {max_depth}, with at least one row: got N={n}, F_in={f_in}, "
            f"hidden={hidden}, f_out={f_out}, depth={depth}"
        )
    x_ptr = _check("x", x, (n, f_in))
    dims = [f_in] + [hidden] * depth + [f_out]
    w_ptrs = (_P * (depth + 1))(*(
        _check(f"w{i}", w, (dims[i], dims[i + 1])) for i, w in enumerate(weights)
    ))
    b_ptrs = (_P * (depth + 1))(*(
        _check(f"b{i}", b, (dims[i + 1],)) for i, b in enumerate(biases)
    ))
    out = torch.empty((n, f_out), dtype=torch.float32, device=x.device)
    pre = (torch.empty((depth, n, hidden), dtype=torch.float32, device=x.device)
           if save_pre else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().selu_mlp_launch(
        x_ptr, w_ptrs, b_ptrs, out.data_ptr(),
        None if pre is None else pre.data_ptr(),
        n, f_in, hidden, depth, f_out, stream,
    )
    if err != 0:
        raise RuntimeError(f"selu_mlp kernel launch failed: cudaError_t {err}")
    LAUNCHES["selu_mlp"] += 1
    return out, pre
