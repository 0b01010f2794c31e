"""Wrapper of the hand-written CUDA flash-attention forward
(``csrc/flash_attention.cu``).

:func:`flash_attention_cuda` runs one launch of the kernel that replaces the
reference's ``_flash_fwd`` (online-softmax attention with GQA, causal
masking, a sliding window and ``q_offset``), returning ``(out, lse)``. It
takes CUDA tensors in float32 or bf16, checks their device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream and raises if the launch is refused. :data:`LAUNCHES` counts
its launches. The plain version is :func:`repro_torch.kernels.ref.flash_attention`
and :func:`repro_torch.kernels.ops.flash_attention` dispatches between them
by device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES", "reset_launches", "dtype_code", "check_tensor", "limits", "flash_attention_cuda",
]

#: Launch count of the kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["flash_attention_fwd"] = 0


def dtype_code(x: torch.Tensor) -> int:
    """The kernels' input type code: 0 float32, 1 bfloat16."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the attention and mLSTM kernels take float32 or bfloat16, got {x.dtype}")
    return _DTYPES[x.dtype]


def check_tensor(name: str, x: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    """``x.data_ptr()`` after checking that ``x`` is a contiguous CUDA tensor
    of ``shape`` and ``dtype``; raises otherwise."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_fwd_launch.argtypes = [_P] * 5 + [_I] * 9 + [_F, _I, _P]
        lib.flash_attention_fwd_launch.restype = _I
        lib.flash_attention_limits.argtypes = [ctypes.POINTER(_I)]
        lib.flash_attention_limits.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> int:
    """The kernel's largest head dim."""
    d = _I()
    _lib().flash_attention_limits(ctypes.byref(d))
    return d.value


def flash_attention_cuda(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] float32)`` on the
    card; ``D <= limits()`` (64), ``Hq`` a multiple of ``Hkv``."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0 or None, got {window}")
    code = dtype_code(q)
    ptrs = [check_tensor("q", q, (B, Sq, Hq, D), q.dtype),
            check_tensor("k", k, (B, Skv, Hkv, D), q.dtype),
            check_tensor("v", v, (B, Skv, Hkv, D), q.dtype)]
    max_d = limits()
    if Hkv < 1 or Hq % Hkv or not 1 <= D <= max_d or min(B, Sq, Skv) < 1:
        raise ValueError(
            f"flash_attention kernel takes D <= {max_d} and Hq a multiple of Hkv, "
            f"non-empty: got q {tuple(q.shape)}, k {tuple(k.shape)}"
        )
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd_launch(
        *ptrs, out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
        int(causal), -1 if window is None else int(window), int(q_offset),
        D ** -0.5 if scale is None else float(scale), code, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse
