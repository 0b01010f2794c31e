"""Public model API: ``init_params``, ``init_cache``, ``loss_fn``,
``init_train_state``, ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``.

The port of the reference package's ``repro.models.model`` with the
reference's step signatures: a train step ``(state, batch) -> (state,
metrics)``, a prefill step ``(params, cache, batch) -> (logits, cache)`` and
a serve (one-token decode) step ``(params, cache, tokens) -> (logits,
cache)``. ``params`` is the :class:`~repro_torch.models.transformer.Transformer`
module; the steps run where its parameters live. ``init_params`` and
``init_cache`` run on ``cuda`` unless the caller passes ``device="cpu"``.

The serving steps run under ``torch.no_grad()`` (no autograd graph: the
parameters require grad for training) and update ``cache`` in place. The
train step updates in place too: the state's module keeps its identity and
its parameters are overwritten with the new values (``p.copy_``), where the
reference returns a new parameter tree.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.engine import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    decompress_grads,
)

__all__ = [
    "init_params",
    "init_cache",
    "loss_fn",
    "loss_and_grads",
    "init_train_state",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]

State = Dict[str, Any]


def init_params(seed: int, cfg: ModelConfig, *, device: DeviceLike = None) -> T.Transformer:
    """The model with seeded random weights (normal, ``fan_in ** -0.5``;
    norms and gate biases as the reference sets them), drawn on ``device``
    from a generator seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(operator.index(seed))
    return T.Transformer(cfg, g)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> T.Cache:
    """An empty KV / SSD cache for ``batch`` sequences of up to ``max_len``
    tokens on ``device``."""
    return T.init_cache(cfg, batch, max_len, device=resolve_device(device))


# ===========================================================================
# training
# ===========================================================================
def loss_fn(
    params: T.Transformer,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"ce", "aux"})`` of ``batch["tokens"] [B, S]``: next-token
    cross entropy (targets the tokens shifted by one, the last position
    masked) unless the batch brings ``targets`` and ``loss_mask``, plus
    ``aux_weight`` times the MoE auxiliary loss."""
    logits, aux = T.forward(params, batch, cfg)
    targets = batch.get("targets")
    if targets is None:
        tokens = batch["tokens"].to(logits.device)
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
        mask[:, -1] = 0.0
    else:
        targets = targets.to(logits.device)
        mask = batch.get("loss_mask")
    ce = cross_entropy_loss(logits, targets, mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def loss_and_grads(
    params: T.Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(loss, metrics, grads)`` with the gradient of every parameter, by
    name, in its own dtype (the reference's ``jax.value_and_grad``)."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    detach = lambda m: {k: v.detach() for k, v in m.items()}
    return loss.detach(), detach(metrics), dict(zip(names, grads))


def init_train_state(params: T.Transformer, opt_cfg: AdamWConfig) -> State:
    """``{"params": the module, "opt": AdamWState keyed by parameter name,
    "step": int32 0}`` on the module's device."""
    return {
        "params": params,
        "opt": adamw_init({k: p.detach() for k, p in params.named_parameters()}, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=params.embed.device),
    }


def _check_trainable(cfg: ModelConfig) -> None:
    """SSD heads run the mLSTM kernel, which has no backward yet: such a
    config does not train, on any device."""
    ssd = {BlockKind.MAMBA, BlockKind.HYMBA, BlockKind.HYMBA_LOCAL} & set(cfg.layer_kinds)
    if ssd:
        raise blocks.unported(
            f"training through SSD heads (block kinds {sorted(ssd)}: the mLSTM / SSD "
            "kernel's backward)")


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    compress: bool = False,
    grad_accum: int = 1,
) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, metrics ``loss``,
    ``grad_norm``, ``ce`` and ``aux`` (0-d tensors).

    With ``grad_accum > 1`` the batch's leading axis is split into that many
    microbatches, run one after another, whose float32-summed gradients are
    averaged (metrics too). ``compress=True`` rounds the gradients to bf16
    with float32 error feedback carried in ``state["grad_error"]``. The
    AdamW update is the functional one; its new values are then copied into
    the module's parameters in place (under ``torch.no_grad()``), so the
    state's module keeps its identity from step to step.
    """
    _check_trainable(cfg)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: State, batch: Dict[str, torch.Tensor]) -> Tuple[State, Dict]:
        net = state["params"]
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} does not split into {grad_accum} microbatches")
            gsum, losses, metricses = None, [], []
            for i in range(grad_accum):
                mb = {k: torch.chunk(x, grad_accum, dim=0)[i] for k, x in batch.items()}
                loss_i, metrics_i, grads_i = loss_and_grads(net, mb, cfg)
                if gsum is None:
                    gsum = {k: g.to(torch.float32) for k, g in grads_i.items()}
                else:
                    for k, g in grads_i.items():
                        gsum[k] += g
                losses.append(loss_i)
                metricses.append(metrics_i)
            grads = {k: g / grad_accum for k, g in gsum.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        else:
            loss, metrics, grads = loss_and_grads(net, batch, cfg)

        new_state = {"step": state["step"] + 1}
        with torch.no_grad():
            if compress:
                grads, new_state["grad_error"] = compress_grads(grads, state.get("grad_error"))
                grads = decompress_grads(grads)
            named = dict(net.named_parameters())
            new_params, new_state["opt"], gnorm = adamw_update(
                grads, state["opt"], {k: p.detach() for k, p in named.items()}, opt_cfg)
            for k, p in named.items():
                p.copy_(new_params[k])
        new_state["params"] = net
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


# ===========================================================================
# serving
# ===========================================================================
def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, cache, {"tokens": [B, S]}) -> (last-position
    logits [B, V], cache)``, under ``torch.no_grad()``."""

    def prefill_step(params: T.Transformer, cache: T.Cache, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            return T.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode step: ``serve_step(params, cache, tokens [B]) ->
    (logits [B, V], cache)``, under ``torch.no_grad()``."""

    def serve_step(params: T.Transformer, cache: T.Cache, tokens: torch.Tensor):
        with torch.no_grad():
            return T.decode_step(params, tokens, cache, cfg)

    return serve_step
