"""AALR ratio classifier (paper Section 5), optionally scenario-conditioned.

The port of ``repro.core.classifier``. A SELU MLP with 4 hidden layers x 128
units learns to tell dependent tuples ``(theta, x ~ p(x|theta))`` (label 1)
from marginal tuples ``(theta, x ~ p(x))`` (label 0); its logit is the log
likelihood-to-marginal ratio ``log r(x|theta)`` the likelihood-free MCMC
reads. With ``ClassifierConfig(context_dim=F)`` each tuple also carries a
scenario context row that stays paired with its ``x`` when the marginal
class shuffles theta, so the logit is the conditional ratio ``log r(x |
theta, s)``.

Parameters are a plain dict of float32 tensors with the reference's keys
``w0..wD`` / ``b0..bD`` (``convert.classifier_from_reference`` copies the
reference's pytree across). Every logit goes through
:func:`repro_torch.kernels.ops.selu_mlp`: on the card the CUDA kernel and
its autograd backward, on the CPU the plain version. Keys are the port's
threefry keys, split on the reference's schedule, so initial weights,
epoch orders and theta shuffles are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = [
    "ClassifierConfig",
    "init_classifier",
    "classifier_logit",
    "log_ratio",
    "bce_loss",
    "train_classifier",
    "epoch_batch_starts",
    "TrainMetrics",
]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    theta_dim: int = 3
    x_dim: int = 3
    context_dim: int = 0  # scenario summary features (0 = unconditional)
    hidden: int = 128
    depth: int = 4  # hidden layers (paper: 4 x 128, SELU)
    lr: float = 1e-4  # paper: ADAM, lr = 0.0001

    @property
    def in_dim(self) -> int:
        return self.theta_dim + self.x_dim + self.context_dim


def init_classifier(key: torch.Tensor, cfg: ClassifierConfig) -> Params:
    """LeCun-normal weights and zero biases on the key's device, one key
    split per layer as the reference splits them."""
    dims = [cfg.in_dim] + [cfg.hidden] * cfg.depth + [1]
    params: Params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        key, sub = prng.split(key, 2)
        params[f"w{i}"] = prng.normal(sub, (din, dout)) * (din ** -0.5)
        params[f"b{i}"] = torch.zeros((dout,), dtype=torch.float32, device=key.device)
    return params


def _split(params: Params) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    n = len(params) // 2
    return (tuple(params[f"w{i}"] for i in range(n)),
            tuple(params[f"b{i}"] for i in range(n)))


def classifier_logit(
    params: Params,
    theta: torch.Tensor,
    x: torch.Tensor,
    context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Logit of d(theta, x[, context]); inputs already projected to (0, 1).
    ``context`` is the per-tuple scenario feature vector of a conditional
    net (``None`` and a zero-width tensor are the same)."""
    parts = [theta, x] if context is None else [theta, x, context]
    inp = torch.cat(parts, dim=-1)
    squeeze = inp.dim() == 1
    if squeeze:
        inp = inp[None]
    ws, bs = _split(params)
    out = ops.selu_mlp(inp, ws, bs)[..., 0]
    return out[0] if squeeze else out


def log_ratio(
    params: Params,
    theta: torch.Tensor,
    x: torch.Tensor,
    context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """log r(x|theta[, s]) = logit(d), the AALR identity."""
    return classifier_logit(params, theta, x, context)


def bce_loss(
    params: Params,
    theta: torch.Tensor,  # [N, theta_dim]
    x: torch.Tensor,  # [N, x_dim]
    labels: torch.Tensor,  # [N] in {0, 1}
    context: Optional[torch.Tensor] = None,  # [N, context_dim]
) -> torch.Tensor:
    logits = classifier_logit(params, theta, x, context)
    return torch.mean(
        torch.clamp(logits, min=0.0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    accuracy: torch.Tensor


def _make_batch(
    theta: torch.Tensor,
    x: torch.Tensor,
    context: torch.Tensor,
    order: torch.Tensor,
    perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One half-dependent / half-marginal training batch. Only theta is
    shuffled for the marginal class: ``(x, context)`` stay paired, so the
    logit becomes the conditional ratio ``log r(x | theta, s)``."""
    bt, bx, bc = theta[order], x[order], context[order]
    half = bt.shape[0] // 2
    theta_in = torch.cat([bt[:half], bt[perm][half:]], dim=0)
    labels = torch.cat([
        torch.ones((half,), dtype=torch.float32, device=theta.device),
        torch.zeros((bt.shape[0] - half,), dtype=torch.float32, device=theta.device),
    ])
    return theta_in, bx, bc, labels


def epoch_batch_starts(n: int, batch_size: int) -> np.ndarray:
    """Start offsets of one epoch's minibatch slices into the shuffled order:
    ``ceil(n / batch_size)`` fixed-size steps, the last shifted back to end
    exactly at ``n`` so that the tail tuples train every epoch."""
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} exceeds n {n}")
    steps = max(-(-n // batch_size), 1)
    return np.minimum(
        np.arange(steps, dtype=np.int64) * batch_size, n - batch_size
    ).astype(np.int32)


def _train_epoch(
    params: Params,
    opt_state: AdamWState,
    theta: torch.Tensor,
    x: torch.Tensor,
    context: torch.Tensor,
    key: torch.Tensor,
    cfg: AdamWConfig,
    batch_size: int,
) -> Tuple[Params, AdamWState, TrainMetrics]:
    """One epoch, a Python loop over the reference's ``lax.scan`` steps:
    the epoch order and each step's theta shuffle come from the
    reference's key schedule (every step's shuffle drawn ahead in one
    batched call). Two forward launches per step (the loss, then the
    accuracy logits under the updated weights) and one backward."""
    n = theta.shape[0]
    k_order, k_scan = prng.split(key, 2)
    order = prng.permutation(k_order, n)
    starts = epoch_batch_starts(n, batch_size)
    perms = prng.permutation(prng.split(k_scan, len(starts)), batch_size)
    loss = acc = None
    for start, perm in zip(starts.tolist(), perms):
        idx = order[start:start + batch_size]
        theta_in, x_in, ctx_in, labels = _make_batch(theta, x, context, idx, perm)
        leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
        loss = bce_loss(leaves, theta_in, x_in, labels, ctx_in)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, opt_state, _ = adamw_update(grads, opt_state, params, cfg)
        with torch.no_grad():
            logits = classifier_logit(params, theta_in, x_in, ctx_in)
            acc = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean()
    return params, opt_state, TrainMetrics(loss=loss.detach(), accuracy=acc)


def train_classifier(
    key: torch.Tensor,
    cfg: ClassifierConfig,
    theta: torch.Tensor,  # [N, theta_dim] projected to (0,1)
    x: torch.Tensor,  # [N, x_dim] projected to (0,1)
    context: Optional[torch.Tensor] = None,  # [N, context_dim] projected to (0,1)
    *,
    epochs: int = 10,
    batch_size: int = 4096,
) -> Tuple[Params, TrainMetrics]:
    """Train the ratio classifier on dependent/marginal pairs, on the
    device of ``theta`` (the key moves there).

    The marginal class shuffles theta within the batch; a context row stays
    paired with its x, which makes the learned ratio conditional on the
    scenario. A non-divisible ``n`` folds its tail into a final overlapping
    step (:func:`epoch_batch_starts`)."""
    n = theta.shape[0]
    dev = theta.device
    if context is None:
        context = torch.zeros((n, 0), dtype=theta.dtype, device=dev)
    if context.dim() != 2 or context.shape[0] != n:
        raise ValueError(f"context must be [n={n}, context_dim]: {tuple(context.shape)}")
    if context.shape[1] != cfg.context_dim:
        raise ValueError(
            f"context width {context.shape[1]} != cfg.context_dim {cfg.context_dim}"
        )
    batch_size = min(batch_size, n)
    key = key.to(dev)
    key, init_key = prng.split(key, 2)
    params = init_classifier(init_key, cfg)
    opt_state = adamw_init(params, AdamWConfig(lr=cfg.lr))
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=dev)
    adam = AdamWConfig(lr=lambda step: lr)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = TrainMetrics(zero, zero)
    for _ in range(epochs):
        key, epoch_key = prng.split(key, 2)
        params, opt_state, metrics = _train_epoch(
            params, opt_state, theta, x, context, epoch_key, adam, batch_size
        )
    return params, metrics
