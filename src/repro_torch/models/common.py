"""Shared model building blocks: RMS norm, rotary embeddings, initialisers
and the cross-entropy loss.

The port of the reference package's ``repro.models.common``, for the
serving and training paths. Parameters are drawn from an explicit ``torch.Generator``;
the same seed gives other numbers than ``jax.random``, so tests carry the
reference's weights across with :mod:`repro_torch.convert`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DTYPES", "rms_norm", "rope_inv_freq", "rope", "apply_rope", "dense_init",
    "cross_entropy_loss",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the reference's ``(1 + scale)`` gain, cast
    back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope_inv_freq(hd: int, theta: float) -> np.ndarray:
    """The ``[hd / 2]`` inverse frequencies, computed in numpy float32 as the
    reference computes them."""
    return (1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))).astype(np.float32)


def rope(positions: torch.Tensor, inv_freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions``: ``([..., hd/2] cos, sin)`` in
    float32, from :func:`rope_inv_freq` held on the device (the model keeps
    it as a buffer, so a decode step makes no host copy)."""
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., S, H, hd]`` by split halves (not interleaved) with
    ``cos``/``sin [..., S, hd/2]`` broadcast over heads, in float32."""
    xf = x.to(torch.float32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(
    generator: torch.Generator,
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    fan_in: Optional[int] = None,
) -> torch.Tensor:
    """Normal weights scaled by ``fan_in ** -0.5`` (default ``shape[0]``),
    drawn in float32 on the generator's device and cast to ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (w * fan_in ** -0.5).to(dtype)


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V] (any float dtype; upcast here)
    targets: torch.Tensor,  # [B, S] int
    mask: Optional[torch.Tensor] = None,  # [B, S]
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in float32 (``logsumexp``
    minus the target's logit), over the positions ``mask`` keeps when given."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
