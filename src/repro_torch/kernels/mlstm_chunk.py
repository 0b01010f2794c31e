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
(xLSTM's 512-wide heads), bf16 calls with chunks a multiple of 16 (either
flag) run two tensor-core launches (:func:`uses_wide`):
``mlstm_wide_state_kernel`` walks the chunks for the state, ``q C`` and
``q . n``, and ``mlstm_wide_out_kernel`` computes each chunk's scores, the
normaliser and the output, through a float32 scratch buffer this wrapper
allocates; their rounding is ``ref.mlstm_chunk_tc`` with the flag. The
other calls past ``Dk = 64`` (float32, other chunks) run
``mlstm_chunk_tiled_kernel`` (:func:`uses_tiled`), which streams q and k
through shared memory in Dk tiles, float32 on the CUDA cores.
:data:`LAUNCHES` counts the launches: ``"mlstm_chunk"`` those of the two
kernels up to ``Dk = 64``, ``"mlstm_chunk_tiled"`` those of the tiled one,
``"mlstm_wide_state"`` and ``"mlstm_wide_out"`` those of the pair (one each
a call). The plain versions are
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

__all__ = ["LAUNCHES", "reset_launches", "limits", "uses_mma", "uses_wide", "uses_tiled",
           "mma_occupancy", "tiled_occupancy", "wide_occupancy", "mlstm_chunk_cuda"]

#: Launch counts: ``"mlstm_chunk"`` raised by one at every launch of the
#: kernels up to ``Dk = 64``, ``"mlstm_chunk_tiled"`` at every launch of the
#: Dk-tiled kernel, ``"mlstm_wide_state"`` and ``"mlstm_wide_out"`` at every
#: launch of the tensor-core pair past ``Dk = 64``.
LAUNCHES: Dict[str, int] = {"mlstm_chunk": 0, "mlstm_chunk_tiled": 0, "mlstm_wide_state": 0,
                            "mlstm_wide_out": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk")
    if not getattr(lib, "_repro_bound", False):
        lib.mlstm_chunk_launch.argtypes = [_P] * 7 + [_I] * 7 + [_F] * 3 + [_I, _P]
        lib.mlstm_chunk_launch.restype = _I
        lib.mlstm_chunk_limits.argtypes = [ctypes.POINTER(_I)] * 2
        lib.mlstm_chunk_limits.restype = _I
        lib.mlstm_chunk_uses_mma.argtypes = [_I] * 4
        lib.mlstm_chunk_uses_mma.restype = _I
        lib.mlstm_chunk_uses_tiled.argtypes = [_I] * 3
        lib.mlstm_chunk_uses_tiled.restype = _I
        lib.mlstm_chunk_uses_wide.argtypes = [_I] * 3
        lib.mlstm_chunk_uses_wide.restype = _I
        lib.mlstm_chunk_scratch_floats.argtypes = [_I] * 7
        lib.mlstm_chunk_scratch_floats.restype = ctypes.c_longlong
        lib.mlstm_chunk_wide_occupancy.argtypes = [ctypes.POINTER(_I)] * 2
        lib.mlstm_chunk_wide_occupancy.restype = _I
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


_CODES = {torch.float32: 0, torch.bfloat16: 1}


def uses_mma(dtype: torch.dtype, normalize: bool, chunk: int, dk: int) -> bool:
    """Whether a call with these arguments runs the tensor-core SSD kernel."""
    return bool(_lib().mlstm_chunk_uses_mma(_CODES[dtype], int(normalize), int(chunk), int(dk)))


def uses_wide(dtype: torch.dtype, chunk: int, dk: int) -> bool:
    """Whether a call runs the tensor-core pair past ``Dk = 64`` (bf16,
    chunks a multiple of 16, either flag)."""
    return bool(_lib().mlstm_chunk_uses_wide(_CODES[dtype], int(chunk), int(dk)))


def uses_tiled(dtype: torch.dtype, chunk: int, dk: int) -> bool:
    """Whether a call runs the Dk-tiled kernel (past ``Dk = 64``, the calls
    :func:`uses_wide` leaves)."""
    return bool(_lib().mlstm_chunk_uses_tiled(_CODES[dtype], int(chunk), int(dk)))


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
    err = _lib().mlstm_chunk_tiled_occupancy(int(dk), _CODES[dtype], ctypes.byref(blocks),
                                             ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"mlstm_chunk tiled occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def wide_occupancy() -> Dict[str, Dict[str, int]]:
    """The tensor-core pair's resident blocks an SM and dynamic shared
    memory a block, by kernel (on the current device)."""
    blocks, smem = (_I * 2)(), (_I * 2)()
    err = _lib().mlstm_chunk_wide_occupancy(blocks, smem)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk wide occupancy query failed: cudaError_t {err}")
    return {name: {"blocks_per_sm": blocks[i], "smem_bytes": smem[i]}
            for i, name in enumerate(("mlstm_wide_state_kernel", "mlstm_wide_out_kernel"))}


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
    n_scratch = _lib().mlstm_chunk_scratch_floats(B, S, H, Dk, Dv, int(chunk), code)
    scratch = torch.empty(n_scratch, dtype=f32, device=q.device) if n_scratch else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().mlstm_chunk_launch(
        *ptrs, out.data_ptr(), None if scratch is None else scratch.data_ptr(), B, S, H, Dk, Dv,
        int(chunk), int(normalize), float(scale), float(eps), 30.0 if normalize else 0.0, code,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: cudaError_t {err}")
    if uses_wide(q.dtype, chunk, Dk):
        LAUNCHES["mlstm_wide_state"] += 1
        LAUNCHES["mlstm_wide_out"] += 1
    else:
        LAUNCHES["mlstm_chunk_tiled" if uses_tiled(q.dtype, chunk, Dk) else "mlstm_chunk"] += 1
    return out
