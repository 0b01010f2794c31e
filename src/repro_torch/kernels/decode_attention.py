"""Wrapper of the hand-written CUDA decode attention
(``csrc/decode_attention.cu``).

:func:`decode_attention_cuda` runs one launch of the kernel that replaces
the reference's ``decode_attention_pallas``: one query token per sequence
against its ``[B, S, Hkv, D]`` KV cache, positions ``>= lengths[b]``
masked, all query heads of a KV group reading each cache row once. It takes
CUDA tensors (q and the cache in float32 or bf16, lengths int32), checks
them, allocates its output with ``torch.empty``, launches on the current
stream and raises if the launch is refused. :data:`LAUNCHES` counts its
launches. The plain version is
:func:`repro_torch.kernels.ref.decode_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_tensor, dtype_code

__all__ = ["LAUNCHES", "reset_launches", "limits", "decode_attention_cuda"]

#: Launch count of the kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.decode_attention_launch.argtypes = [_P] * 5 + [_I] * 5 + [_F, _I, _P]
        lib.decode_attention_launch.restype = _I
        lib.decode_attention_limits.argtypes = [ctypes.POINTER(_I)] * 2
        lib.decode_attention_limits.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int]:
    """The kernel's largest ``(Hq / Hkv, D)``."""
    vals = [_I() for _ in range(2)]
    _lib().decode_attention_limits(*(ctypes.byref(x) for x in vals))
    return tuple(x.value for x in vals)


def decode_attention_cuda(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``out [B, Hq, D]`` in q's dtype, on the card."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    code = dtype_code(q)
    ptrs = [check_tensor("q", q, (B, Hq, D), q.dtype),
            check_tensor("k_cache", k_cache, (B, S, Hkv, D), q.dtype),
            check_tensor("v_cache", v_cache, (B, S, Hkv, D), q.dtype),
            check_tensor("lengths", lengths, (B,), torch.int32)]
    max_g, max_d = limits()
    if Hkv < 1 or Hq % Hkv or Hq // Hkv > max_g or not 1 <= D <= max_d or min(B, S) < 1:
        raise ValueError(
            f"decode_attention kernel takes Hq a multiple of Hkv with at most "
            f"{max_g} query heads per KV head and D <= {max_d}: got q "
            f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}"
        )
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        *ptrs, out.data_ptr(), B, S, Hq, Hkv, D,
        D ** -0.5 if scale is None else float(scale), code, stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["decode_attention"] += 1
    return out
