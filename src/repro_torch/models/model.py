"""Public model API of the serving path: ``init_params``, ``init_cache``,
``make_prefill_step`` and ``make_serve_step``.

The port of the reference package's ``repro.models.model`` with the
reference's step signatures: a prefill step ``(params, cache, batch) ->
(logits, cache)`` and a serve (one-token decode) step ``(params, cache,
tokens) -> (logits, cache)``. ``params`` is the
:class:`~repro_torch.models.transformer.Transformer` module; the steps run
where its parameters live and update ``cache`` in place. ``init_params`` and
``init_cache`` run on ``cuda`` unless the caller passes ``device="cpu"``.
The training half (``loss_fn``, ``make_train_step``) comes with the
training slice (ROADMAP A.12).
"""
from __future__ import annotations

import operator
from typing import Callable, Dict

import torch

from repro_torch.core.engine import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "make_prefill_step", "make_serve_step"]


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


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, cache, {"tokens": [B, S]}) -> (last-position
    logits [B, V], cache)``."""

    def prefill_step(params: T.Transformer, cache: T.Cache, batch: Dict[str, torch.Tensor]):
        return T.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode step: ``serve_step(params, cache, tokens [B]) ->
    (logits [B, V], cache)``."""

    def serve_step(params: T.Transformer, cache: T.Cache, tokens: torch.Tensor):
        return T.decode_step(params, tokens, cache, cfg)

    return serve_step
