"""Wrappers of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

:func:`flash_attention_cuda` runs one launch of the forward kernel that
replaces the reference's ``_flash_fwd`` (online-softmax attention with GQA,
causal masking, a sliding window and ``q_offset``), returning ``(out,
lse)``. :func:`flash_attention_bwd_cuda` runs the two backward kernels that
replace ``flash_attention_bwd_pallas``: :func:`flash_attention_bwd_dq_cuda`
(dq, and ``delta`` for the next one), then
:func:`flash_attention_bwd_dkv_cuda` (dk and dv, a KV head's query heads
summed in the kernel). bf16 inputs run all three on the tensor cores
(``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
``flash_bwd_dkv_mma_kernel``: bf16 operands, float32 sums, p and ds rounded
to bf16 before their products); float32 inputs run float32 CUDA-core
kernels. All three take head dims up to 128 (:func:`limits`), each compiled
at widths 64 (D <= 64) and 128. Each takes CUDA tensors in float32 or bf16,
checks
their device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream and raises if the launch is
refused. :data:`LAUNCHES` counts each kernel's launches. The plain versions
are :func:`repro_torch.kernels.ref.flash_attention` and
:func:`~repro_torch.kernels.ref.flash_attention_bwd`;
:class:`repro_torch.kernels.ops.FlashAttention` dispatches between them by
device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES", "reset_launches", "dtype_code", "check_tensor", "limits", "mma_occupancy",
    "flash_attention_cuda",
    "flash_attention_bwd_dq_cuda", "flash_attention_bwd_dkv_cuda", "flash_attention_bwd_cuda",
]

#: Launch count of each kernel, raised by one at every launch.
LAUNCHES: Dict[str, int] = {
    "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
        for name in ("flash_attention_bwd_dq_launch", "flash_attention_bwd_dkv_launch"):
            getattr(lib, name).argtypes = [_P] * 8 + [_I] * 9 + [_F, _I, _P]
            getattr(lib, name).restype = _I
        lib.flash_attention_limits.argtypes = [ctypes.POINTER(_I)] * 2
        lib.flash_attention_limits.restype = _I
        lib.flash_attention_mma_occupancy.argtypes = [ctypes.POINTER(_I)]
        lib.flash_attention_mma_occupancy.restype = _I
        lib._repro_bound = True
    return lib


def limits() -> Tuple[int, int]:
    """The largest head dims of the forward and of the backward kernels."""
    fwd, bwd = _I(), _I()
    _lib().flash_attention_limits(ctypes.byref(fwd), ctypes.byref(bwd))
    return fwd.value, bwd.value


def mma_occupancy() -> Dict[str, int]:
    """Blocks an SM holds of the bf16 tensor-core kernels (the forward, dq
    and dk/dv, each at widths 64 and 128), from the CUDA occupancy
    calculator."""
    names = [f"flash_attention_{k}{w}" for k in ("fwd", "bwd_dq", "bwd_dkv")
             for w in ("", "_d128")]
    vals = (_I * len(names))()
    err = _lib().flash_attention_mma_occupancy(vals)
    if err != 0:
        raise RuntimeError(f"flash_attention occupancy query failed: cudaError_t {err}")
    return dict(zip(names, vals))


def _shapes(q: torch.Tensor, k: torch.Tensor, window: Optional[int], what: str):
    """``(B, Sq, Hq, D, Skv, Hkv)`` of 4-d ``q`` and ``k``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q must be [B, Sq, Hq, D] and k [B, Skv, Hkv, D]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"{what}: window must be >= 0 or None, got {window}")
    return (*q.shape, k.shape[1], k.shape[2])


def _check_shapes(shapes, q: torch.Tensor, k: torch.Tensor, what: str, backward: bool) -> None:
    """Raise unless the forward (or, with ``backward``, the backward)
    kernels take these shapes (after the tensors' own checks: this loads the
    library); the message names the limit that refused."""
    B, Sq, Hq, D, Skv, Hkv = shapes
    max_d = limits()[1 if backward else 0]
    limit = "the backward's" if backward else "the forward's"
    if Hkv < 1 or Hq % Hkv or not 1 <= D <= max_d or min(B, Sq, Skv) < 1:
        raise ValueError(
            f"{what} kernel takes D <= {max_d} ({limit} limit) and Hq a multiple of Hkv, "
            f"non-empty: got q {tuple(q.shape)}, k {tuple(k.shape)}"
        )


def _launch_args(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, scale, code, q):
    return (B, Sq, Skv, Hq, Hkv, D, int(causal), -1 if window is None else int(window),
            int(q_offset), D ** -0.5 if scale is None else float(scale), code,
            torch.cuda.current_stream(q.device).cuda_stream)


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
    card; ``D <= limits()[0]`` (128), ``Hq`` a multiple of ``Hkv``."""
    code = dtype_code(q)
    shapes = _shapes(q, k, window, "flash_attention")
    B, Sq, Hq, D, Skv, Hkv = shapes
    ptrs = [check_tensor("q", q, (B, Sq, Hq, D), q.dtype),
            check_tensor("k", k, (B, Skv, Hkv, D), q.dtype),
            check_tensor("v", v, (B, Skv, Hkv, D), q.dtype)]
    _check_shapes(shapes, q, k, "flash_attention", backward=False)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_fwd_launch(
        *ptrs, out.data_ptr(), lse.data_ptr(),
        *_launch_args(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, scale, code, q),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _bwd_inputs(q, k, v, lse, dout, window, what):
    """Checked pointers of the backward's common inputs (q, k, v, dout in
    q's dtype, lse float32) and the shapes."""
    code = dtype_code(q)
    shapes = _shapes(q, k, window, what)
    B, Sq, Hq, D, Skv, Hkv = shapes
    ptrs = dict(q=check_tensor("q", q, (B, Sq, Hq, D), q.dtype),
                k=check_tensor("k", k, (B, Skv, Hkv, D), q.dtype),
                v=check_tensor("v", v, (B, Skv, Hkv, D), q.dtype),
                dout=check_tensor("dout", dout, (B, Sq, Hq, D), q.dtype),
                lse=check_tensor("lse", lse, (B, Hq, Sq), torch.float32))
    _check_shapes(shapes, q, k, what, backward=True)
    return code, shapes, ptrs


def flash_attention_bwd_dq_cuda(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    out: torch.Tensor,  # [B, Sq, Hq, D] forward output
    lse: torch.Tensor,  # [B, Hq, Sq] forward log-sum-exp
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's first kernel (``D <= limits()[1]``, 128): ``(dq [B, Sq,
    Hq, D] in q's dtype, delta [B, Hq, Sq] float32)``, ``delta = sum_d dout
    out`` for :func:`flash_attention_bwd_dkv_cuda`."""
    code, (B, Sq, Hq, D, Skv, Hkv), p = _bwd_inputs(q, k, v, lse, dout, window,
                                                     "flash_attention backward")
    o = check_tensor("out", out, (B, Sq, Hq, D), q.dtype)
    dq = torch.empty_like(q)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_bwd_dq_launch(
        p["q"], p["k"], p["v"], o, p["dout"], p["lse"], delta.data_ptr(), dq.data_ptr(),
        *_launch_args(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, scale, code, q),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention dq kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq, delta


def flash_attention_bwd_dkv_cuda(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    lse: torch.Tensor,  # [B, Hq, Sq] forward log-sum-exp
    delta: torch.Tensor,  # [B, Hq, Sq] from flash_attention_bwd_dq_cuda
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's second kernel: ``(dk, dv [B, Skv, Hkv, D])`` in q's
    dtype, each KV head's query heads summed in the kernel."""
    code, (B, Sq, Hq, D, Skv, Hkv), p = _bwd_inputs(q, k, v, lse, dout, window,
                                                     "flash_attention backward")
    dl = check_tensor("delta", delta, (B, Hq, Sq), torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().flash_attention_bwd_dkv_launch(
        p["q"], p["k"], p["v"], p["dout"], p["lse"], dl, dk.data_ptr(), dv.data_ptr(),
        *_launch_args(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, scale, code, q),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention dk/dv kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    out: torch.Tensor,  # [B, Sq, Hq, D] forward output
    lse: torch.Tensor,  # [B, Hq, Sq] forward log-sum-exp
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` on the card, in q's dtype: the dq kernel, then the
    dk/dv kernel on the same stream."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, dout, **kw)
    return dq, dk, dv
