"""Wrapper of the hand-written CUDA decode attention
(``csrc/decode_attention.cu``).

:func:`decode_attention_cuda` runs one launch of the kernel that replaces
the reference's ``decode_attention_pallas``: one query token per sequence
against its ``[B, S, Hkv, D]`` KV cache, positions ``>= lengths[b]``
masked, all query heads of a KV group reading each cache row once. The
kernel splits the cache over :func:`splits` blocks a (batch, KV head) and
merges their float32 partials in the same launch, in split order. It takes
CUDA tensors (q and the cache in float32 or bf16, lengths int32), checks
them, allocates its output and the partials' workspace with
``torch.empty``, launches on the current stream and raises if the launch is
refused. The merge's per-(batch, KV head) ticket counters are one zeroed
int32 buffer a device, allocated at first use and reset by every launch,
so calls on one device must run in stream order (one stream at a time).
:data:`LAUNCHES` counts its launches. The plain version is
:func:`repro_torch.kernels.ref.decode_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_tensor, dtype_code

__all__ = ["LAUNCHES", "reset_launches", "limits", "splits", "decode_attention_cuda"]

#: Launch count of the kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# the merge's ticket counters, int32 zeros by device index
_COUNTERS: Dict[int, torch.Tensor] = {}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.decode_attention_launch.argtypes = [_P] * 7 + [_I] * 6 + [_F, _I, _P]
        lib.decode_attention_launch.restype = _I
        lib.decode_attention_splits.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.decode_attention_splits.restype = _I
        lib.decode_attention_limits.argtypes = [ctypes.POINTER(_I)] * 2
        lib.decode_attention_limits.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int]:
    """The kernel's largest ``(Hq / Hkv, D)``."""
    vals = [_I() for _ in range(2)]
    _lib().decode_attention_limits(*(ctypes.byref(x) for x in vals))
    return tuple(x.value for x in vals)


def splits(B: int, S: int, Hq: int, Hkv: int, D: int, dtype: torch.dtype) -> int:
    """The splits of the cache a launch at these shapes runs on the current
    device (``B * Hkv * splits`` blocks), as the kernel's host code picks
    them from the card's SM count."""
    return _splits(B, S, Hq, Hkv, D, dtype_code(torch.empty(0, dtype=dtype)),
                   torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _splits(B: int, S: int, Hq: int, Hkv: int, D: int, code: int, device: int) -> int:
    n = _I()
    with torch.cuda.device(device):
        err = _lib().decode_attention_splits(B, S, Hq, Hkv, D, code, ctypes.byref(n))
    if err != 0:
        raise ValueError(f"decode_attention kernel does not take B={B}, S={S}, Hq={Hq}, "
                         f"Hkv={Hkv}, D={D}: cudaError_t {err}")
    return n.value


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed ticket counters, at least ``n`` of them."""
    idx = _index(device)
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[idx] = buf
    return buf


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
    n_splits = _splits(B, S, Hq, Hkv, D, code, _index(q.device))
    out = torch.empty_like(q)
    work = torch.empty(B * n_splits * Hq * (D + 2), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * Hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        *ptrs, out.data_ptr(), work.data_ptr(), counters.data_ptr(), n_splits, B, S, Hq, Hkv, D,
        D ** -0.5 if scale is None else float(scale), code, stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["decode_attention"] += 1
    return out
