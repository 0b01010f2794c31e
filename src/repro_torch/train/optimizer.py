"""AdamW, global-norm clipping and learning-rate schedules.

The port of ``repro.train.optimizer`` for parameter dicts of tensors: the
update is functional (new parameter and state dicts come back, the inputs
are left as they are) and follows the reference's formula, ``mhat /
(sqrt(vhat) + eps)`` with bias corrections taken from the float32 step
count. ``torch.optim.AdamW`` adds ``eps`` at another place and would not
match. The bf16 gradient-compression helpers belong to the LLM substrate
and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "warmup_cosine",
    "constant_lr",
]

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Schedule, float] = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    # store first/second moments in this dtype
    state_dtype: Any = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] i32
    mu: Params
    nu: Params


def adamw_init(params: Params, config: AdamWConfig) -> AdamWState:
    first = next(iter(params.values()))
    zeros = lambda p: torch.zeros_like(p, dtype=config.state_dtype)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()},
    )


def _global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    gnorm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gnorm


def adamw_update(
    grads: Params,
    state: AdamWState,
    params: Params,
    config: AdamWConfig,
) -> Tuple[Params, AdamWState, torch.Tensor]:
    """One AdamW step: ``(new_params, new_state, grad_global_norm)``."""
    f32 = torch.float32
    if config.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, config.clip_norm)
    else:
        gnorm = _global_norm(grads)
    step = state.step + 1
    lr = config.lr(step) if callable(config.lr) else torch.tensor(
        config.lr, dtype=f32, device=step.device)
    b1, b2 = config.b1, config.b2
    stepf = step.to(f32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=step.device), stepf)
    new_mu, new_nu, new_params = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(f32)
        m = (state.mu[k].to(f32) * b1 + (1 - b1) * g).to(config.state_dtype)
        v = (state.nu[k].to(f32) * b2 + (1 - b2) * g * g).to(config.state_dtype)
        mhat = m.to(f32) / bc1
        vhat = v.to(f32) / bc2
        delta = mhat / (torch.sqrt(vhat) + config.eps)
        if config.weight_decay:
            delta = delta + config.weight_decay * p.to(f32)
        new_params[k] = (p.to(f32) - lr * delta).to(p.dtype)
        new_mu[k], new_nu[k] = m, v
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), gnorm


# -- learning-rate schedules -------------------------------------------------

def warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.0
) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = floor + (peak_lr - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def constant_lr(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)
