"""Wrapper of the hand-written CUDA chunkwise mLSTM / SSD kernel
(``csrc/mlstm_chunk.cu``).

:func:`mlstm_chunk_cuda` runs one launch of the kernel that replaces the
reference's ``mlstm_chunk_pallas``: the matrix-memory cell, parallel inside
chunks and recurrent across them, with ``normalize=True`` (xLSTM) or
``False`` (SSD). It takes CUDA tensors (q, k, v in float32 or bf16, the
gates float32), checks them, allocates its output with ``torch.empty``,
launches on the current stream and raises if the launch is refused. Up to
``Dk = 64``, bf16 SSD calls (``normalize=False``, chunks a multiple of 16)
run the tensor-core kernel ``mlstm_ssd_mma_kernel`` (:func:`uses_mma`),
whose bf16 rounding :func:`repro_torch.kernels.ref.mlstm_chunk_tc` models,
and the others the CUDA-core ``mlstm_chunk_kernel``. Past ``Dk = 64``
(xLSTM's 512-wide heads) every call runs ``mlstm_chunk_tiled_kernel``
(:func:`uses_tiled`), which streams q and k through shared memory in Dk
tiles, float32 on the CUDA cores. :data:`LAUNCHES` counts the launches,
``"mlstm_chunk"`` those of the two kernels up to ``Dk = 64`` and
``"mlstm_chunk_tiled"`` those of the tiled one. The plain versions are
:func:`repro_torch.kernels.ref.mlstm_chunk` (parallel form) and
:func:`~repro_torch.kernels.ref.mlstm_chunk_chunked` (the kernel's own
recurrence).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_tensor, dtype_code

__all__ = ["LAUNCHES", "reset_launches", "limits", "uses_mma", "uses_tiled", "mma_occupancy",
           "tiled_occupancy", "mlstm_chunk_cuda"]

#: Launch counts: ``"mlstm_chunk"`` raised by one at every launch of the
#: kernels up to ``Dk = 64``, ``"mlstm_chunk_tiled"`` at every launch of the
#: Dk-tiled kernel.
LAUNCHES: Dict[str, int] = {"mlstm_chunk": 0, "mlstm_chunk_tiled": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk")
    if not getattr(lib, "_repro_bound", False):
        lib.mlstm_chunk_launch.argtypes = [_P] * 6 + [_I] * 7 + [_F] * 3 + [_I, _P]
        lib.mlstm_chunk_launch.restype = _I
        lib.mlstm_chunk_limits.argtypes = [ctypes.POINTER(_I)] * 2
        lib.mlstm_chunk_limits.restype = _I
        lib.mlstm_chunk_uses_mma.argtypes = [_I] * 4
        lib.mlstm_chunk_uses_mma.restype = _I
        lib.mlstm_chunk_uses_tiled.argtypes = [_I]
        lib.mlstm_chunk_uses_tiled.restype = _I
        lib.mlstm_chunk_mma_occupancy.argtypes = [_I] + [ctypes.POINTER(_I)] * 2
        lib.mlstm_chunk_mma_occupancy.restype = _I
        lib.mlstm_chunk_tiled_occupancy.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 2
        lib.mlstm_chunk_tiled_occupancy.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int]:
    """The kernels' largest ``(Dk, chunk)``."""
    vals = [_I() for _ in range(2)]
    _lib().mlstm_chunk_limits(*(ctypes.byref(x) for x in vals))
    return tuple(x.value for x in vals)


def uses_mma(dtype: torch.dtype, normalize: bool, chunk: int, dk: int) -> bool:
    """Whether a call with these arguments runs the tensor-core kernel."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    return bool(_lib().mlstm_chunk_uses_mma(code, int(normalize), int(chunk), int(dk)))


def uses_tiled(dk: int) -> bool:
    """Whether a call at this ``Dk`` runs the Dk-tiled kernel."""
    return bool(_lib().mlstm_chunk_uses_tiled(int(dk)))


def mma_occupancy(dk: int) -> Dict[str, int]:
    """The tensor-core kernel's resident blocks an SM and dynamic shared
    memory a block at this ``Dk`` (on the current device)."""
    blocks, smem = _I(), _I()
    err = _lib().mlstm_chunk_mma_occupancy(int(dk), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"mlstm_chunk occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def tiled_occupancy(dk: int, dtype: torch.dtype) -> Dict[str, int]:
    """The Dk-tiled kernel's resident blocks an SM and dynamic shared memory
    a block at this ``Dk`` (past 64) and input dtype (on the current
    device)."""
    blocks, smem = _I(), _I()
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    err = _lib().mlstm_chunk_tiled_occupancy(int(dk), code, ctypes.byref(blocks),
                                             ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"mlstm_chunk tiled occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def mlstm_chunk_cuda(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,  # [B, S, H, Dk]
    v: torch.Tensor,  # [B, S, H, Dv]
    i_gate: torch.Tensor,  # [B, S, H] float32
    f_gate: torch.Tensor,  # [B, S, H] float32
    *,
    chunk: int = 128,
    eps: float = 1e-6,
    normalize: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``out [B, S, H, Dv]`` in q's dtype, on the card. The last chunk is
    padded as the reference pads it: ``i = -1e30`` and ``f = 30``
    (``normalize``) or 0."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    code = dtype_code(q)
    f32 = torch.float32
    ptrs = [check_tensor("q", q, (B, S, H, Dk), q.dtype),
            check_tensor("k", k, (B, S, H, Dk), q.dtype),
            check_tensor("v", v, (B, S, H, Dv), q.dtype),
            check_tensor("i_gate", i_gate, (B, S, H), f32),
            check_tensor("f_gate", f_gate, (B, S, H), f32)]
    max_dk, max_chunk = limits()
    if not 1 <= Dk <= max_dk or not 1 <= chunk <= max_chunk or min(B, S, H, Dv) < 1:
        raise ValueError(
            f"mlstm_chunk kernel takes Dk <= {max_dk} and chunks of at most "
            f"{max_chunk}: got q {tuple(q.shape)}, v {tuple(v.shape)}, chunk {chunk}"
        )
    if scale is None:
        scale = Dk ** -0.5 if normalize else 1.0
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().mlstm_chunk_launch(
        *ptrs, out.data_ptr(), B, S, H, Dk, Dv, int(chunk), int(normalize),
        float(scale), float(eps), 30.0 if normalize else 0.0, code, stream,
    )
    if err != 0:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: cudaError_t {err}")
    LAUNCHES["mlstm_chunk_tiled" if uses_tiled(Dk) else "mlstm_chunk"] += 1
    return out
