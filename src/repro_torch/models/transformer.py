"""Transformer stack: pattern-cycled layers, the full-sequence forward of
training, the KV / SSD caches, prefill and one-token decode.

The port of the reference package's ``repro.models.transformer`` for block
kinds ``ATTN``, ``ATTN_LOCAL``, ``MAMBA``, ``HYMBA`` and ``HYMBA_LOCAL``.
The reference stacks each pattern position's parameters ``[n_units, ...]``
and scans over units; PyTorch runs eagerly, so the port unrolls: the model
is an ``nn.Module`` whose ``layers`` are an ``nn.ModuleList`` in layer order
(unit ``u``, block ``b{i}`` is layer ``u * pattern_len + i``; the tail
follows).

The cache is ``{"pos": int, "layers": [per-layer dict]}``; a layer's entry
holds ``"kv"`` (``k``, ``v [B, size, Hkv, hd]``, a ring of ``window`` slots
on sliding-window layers) and, for SSD heads, ``"ssm"`` (``C``, ``n``,
``m``). ``pos`` is a Python int, so the ring slot and the valid length of a
decode step need no copy from the device. :func:`prefill` and
:func:`decode_step` update the cache in place (KV slots written into the
cache tensors, SSD states replaced in the dict, ``pos`` advanced) and
return it.

:func:`forward` is the training forward, ``(logits [B, S, V], aux)``; under
``cfg.remat`` each layer runs inside ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scanned unit, whose unit is one layer
for the single-kind patterns the port trains), so its activations are
recomputed in the backward instead of kept.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as B
from repro_torch.models.common import DTYPES, rms_norm, rope, rope_inv_freq
from repro_torch.models.config import BlockKind, ModelConfig

__all__ = ["Layer", "Transformer", "forward", "init_cache", "prefill", "decode_step"]

Cache = Dict[str, Any]

_ATTN_KINDS = (BlockKind.ATTN, BlockKind.ATTN_LOCAL, BlockKind.HYMBA, BlockKind.HYMBA_LOCAL)
_HYMBA = (BlockKind.HYMBA, BlockKind.HYMBA_LOCAL)
_LOCAL = (BlockKind.ATTN_LOCAL, BlockKind.HYMBA_LOCAL)


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind in _LOCAL else None


def _local_theta(cfg: ModelConfig, window: Optional[int]) -> bool:
    """Whether a layer takes the sliding-window RoPE base (gemma3-style
    configs set ``rope_theta_local``)."""
    return window is not None and cfg.rope_theta_local is not None


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise B.unported("the encoder-decoder stack (cross-attention)")
    if cfg.frontend:
        raise B.unported(f"the {cfg.frontend} frontend")
    for kind in set(cfg.layer_kinds):
        if kind not in _ATTN_KINDS + (BlockKind.MAMBA,):
            raise B.unported(f"block kind {kind!r}")


class Layer(nn.Module):
    """One layer: ``norm1``, attention and/or SSD heads, ``norm2``, the MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, g: Optional[torch.Generator], device=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.window = _window(cfg, kind)
        d = cfg.d_model
        zeros = lambda: B._const((d,), 0.0, device if g is None else g.device)
        self.norm1 = zeros()
        if kind in _ATTN_KINDS:
            self.attn = B.Attention(cfg, g, device)
            if kind in _HYMBA:
                self.mamba = B.Mamba(cfg, g, device)
        elif kind == BlockKind.MAMBA:
            self.mamba = B.Mamba(cfg, g, device)
        else:
            raise B.unported(f"block kind {kind!r}")
        self.norm2 = zeros()
        self.mlp = B.MLP(cfg, g, device)


class Transformer(nn.Module):
    """The decoder-only model: ``embed [V, d]``, ``layers``, ``final_norm``
    and ``lm_head [d, V]`` (the embedding's transpose when tied). Its RoPE
    inverse frequencies are buffers, so decode computes its tables on the
    device."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        g = generator
        dev = device if g is None else g.device
        dt = DTYPES[cfg.dtype]
        self.embed = B._new(g, (cfg.vocab_size, cfg.d_model), dt, dev, fan_in=cfg.d_model)
        self.final_norm = B._const((cfg.d_model,), 0.0, dev)
        if not cfg.tie_embeddings:
            self.lm_head = B._new(g, (cfg.d_model, cfg.vocab_size), dt, dev)
        self.layers = nn.ModuleList(Layer(cfg, kind, g, dev) for kind in cfg.layer_kinds)
        inv = lambda theta: torch.from_numpy(rope_inv_freq(cfg.hd, theta)).to(dev)
        self.register_buffer("inv_freq", inv(cfg.rope_theta), persistent=False)
        self.register_buffer(
            "inv_freq_local", inv(cfg.rope_theta_local or cfg.rope_theta), persistent=False)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def rope_tables(self, positions: torch.Tensor) -> Dict[bool, Tuple[torch.Tensor, torch.Tensor]]:
        """cos/sin tables for ``positions``, keyed by :func:`_local_theta`."""
        return {False: rope(positions, self.inv_freq), True: rope(positions, self.inv_freq_local)}


# ===========================================================================
# caches
# ===========================================================================
def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device) -> Cache:
    c: Cache = {}
    if kind in _ATTN_KINDS:
        c["kv"] = B.init_attention_cache(
            cfg, batch, max_len, window=_window(cfg, kind), device=device)
    if kind in _HYMBA + (BlockKind.MAMBA,):
        c["ssm"] = B.init_mamba_cache(cfg, batch, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Cache:
    """An empty cache for ``batch`` sequences of up to ``max_len`` tokens."""
    _check_supported(cfg)
    return {
        "pos": 0,
        "layers": [_init_block_cache(cfg, kind, batch, max_len, device)
                   for kind in cfg.layer_kinds],
    }


# ===========================================================================
# prefill
# ===========================================================================
def _write_kv(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Bulk-write a prompt's keys and values into a (ring) cache in place:
    position ``p`` at slot ``p`` when the prompt fits, else the last ``size``
    positions at slot ``p % size``."""
    S = k.shape[1]
    size = cache["k"].shape[1]
    if size >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    else:
        shift = (S - size) % size
        cache["k"].copy_(torch.roll(k[:, S - size:], shifts=shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - size:], shifts=shift, dims=1))


def _block(layer: Layer, x: torch.Tensor, tables, c: Optional[Cache] = None) -> torch.Tensor:
    """One layer over a whole sequence; with a cache ``c`` (prefill) its
    keys, values and SSD state go there."""
    cfg = layer.cfg
    h = rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.kind in _ATTN_KINDS:
        a, k, v = layer.attn(h, tables[_local_theta(cfg, layer.window)], window=layer.window)
        if c is not None:
            _write_kv(c["kv"], k, v)
        if layer.kind in _HYMBA:
            s_out, state = layer.mamba(h)
            a = 0.5 * (a + s_out)
    else:  # MAMBA
        a, state = layer.mamba(h)
    if c is not None and layer.kind in _HYMBA + (BlockKind.MAMBA,):
        c["ssm"] = state
    x = x + a
    return x + layer.mlp(rms_norm(x, layer.norm2, cfg.norm_eps))


# ===========================================================================
# training forward
# ===========================================================================
def forward(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of ``batch["tokens"] [B, S]``: ``(logits [B, S,
    V], aux)``. ``aux`` is the MoE load-balancing loss, 0 for the block
    kinds the port runs."""
    tokens = batch["tokens"].to(params.embed.device)
    S = tokens.shape[1]
    x = params.embed[tokens]
    tables = params.rope_tables(torch.arange(S, device=x.device))
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.layers:
        x = checkpoint(_block, layer, x, tables, use_reentrant=False) if remat \
            else _block(layer, x, tables)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt ``batch["tokens"] [B, S]`` through the model, filling
    ``cache`` in place: ``(last-position logits [B, V], cache)``."""
    tokens = batch["tokens"].to(params.embed.device)
    S = tokens.shape[1]
    x = params.embed[tokens]
    tables = params.rope_tables(torch.arange(S, device=x.device))
    for layer, c in zip(params.layers, cache["layers"]):
        x = _block(layer, x, tables, c)
    cache["pos"] = S
    x = rms_norm(x[:, -1], params.final_norm, cfg.norm_eps)
    return x @ params.head, cache


# ===========================================================================
# decode
# ===========================================================================
def _block_decode(layer: Layer, x: torch.Tensor, c: Cache, pos: int, tables) -> torch.Tensor:
    cfg = layer.cfg
    h = rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.kind in _ATTN_KINDS:
        a = layer.attn.decode(h, c["kv"], tables[_local_theta(cfg, layer.window)], pos=pos)
        if layer.kind in _HYMBA:
            s, c["ssm"] = layer.mamba.decode(h, c["ssm"])
            a = 0.5 * (a + s)
    else:  # MAMBA
        a, c["ssm"] = layer.mamba.decode(h, c["ssm"])
    x = x + a
    return x + layer.mlp(rms_norm(x, layer.norm2, cfg.norm_eps))


def decode_step(params: Transformer, tokens: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One token per sequence, ``tokens [B]`` at position ``cache["pos"]``:
    ``(logits [B, V], cache)``, the cache updated in place."""
    pos = cache["pos"]
    x = params.embed[tokens.to(params.embed.device)]
    tables = params.rope_tables(torch.full((1,), pos, device=x.device))
    for layer, c in zip(params.layers, cache["layers"]):
        x = _block_decode(layer, x, c, pos, tables)
    cache["pos"] = pos + 1
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head, cache
