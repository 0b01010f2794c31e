"""Transformer stack: pattern-cycled layers, the encoder of the
encoder-decoder configs, the modality frontends, the full-sequence forward
of training, the KV / SSD caches, prefill and one-token decode.

The port of the reference package's ``repro.models.transformer``, every
block kind (``ATTN``, ``ATTN_LOCAL``, ``MOE``, ``MAMBA``, ``HYMBA``,
``HYMBA_LOCAL``, ``MLSTM``, ``SLSTM``).
The reference stacks each pattern position's parameters ``[n_units, ...]``
and scans over units; PyTorch runs eagerly, so the port unrolls: the model
is an ``nn.Module`` whose ``layers`` are an ``nn.ModuleList`` in layer order
(unit ``u``, block ``b{i}`` is layer ``u * pattern_len + i``; the tail
follows).

Encoder-decoder configs (``cfg.is_encdec``, seamless-m4t-large-v2) add an
``encoder`` of ``encoder_layers`` plain ``ATTN`` layers, non-causal over
positions ``0..Se-1``, then ``enc_final_norm``; its input is
``batch["frontend_embeds"] [B, Se, frontend_dim]`` (precomputed frame
embeddings) cast to the embedding's dtype and projected by
``frontend_proj``. Each decoder layer then carries ``norm_cross`` and
``cross`` (:class:`~repro_torch.models.blocks.CrossAttention`): after
self-attention and its residual, ``x + cross(norm_cross(x))`` over the
encoder output's keys and values. A vision config (internvl2-2b) projects
its ``frontend_embeds`` the same way and prepends them to the token
embeddings, cutting the sequence back to the prompt's length: the
prompt's last ``frontend_tokens`` tokens drop out, as in the reference.
Decode steps take no frontend.

The cache is ``{"pos": int, "layers": [per-layer dict]}``; a layer's entry
holds ``"kv"`` (``k``, ``v [B, size, Hkv, hd]``, a ring of ``window`` slots
on sliding-window layers; an MoE layer's cache is its attention's) and, for
SSD heads, ``"ssm"`` (``C``, ``n``,
``m``); an xLSTM layer's holds ``"cell"`` (the mLSTM's ``C``, ``n``, ``m``,
the sLSTM's ``h``, ``c``, ``n``, ``m``); an encoder-decoder's layer also
``"cross_kv"`` (``k``, ``v [B, frontend_tokens or max_len, Hkv, hd]``,
zeros until prefill replaces them by the encoder output's). ``pos`` is a
Python int, so the
ring slot and the valid length of a decode step need no copy from the
device. :func:`prefill` and
:func:`decode_step` update the cache in place (KV slots written into the
cache tensors, SSD, xLSTM states and the cross keys replaced in the dict,
``pos`` advanced) and return it.

:func:`forward` is the training forward, ``(logits [B, S, V], aux)``, aux
the sum of the MoE layers' load-balance losses (prefill and decode drop
them, as the reference's do); under
``cfg.remat`` each layer (the encoder's too) runs inside
``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scanned unit, a whole pattern of
layers: the port checkpoints each layer of it, which recomputes the same
values), so its activations are recomputed in the backward instead of kept.
The SSD and xLSTM states at a sequence's end are computed by prefill only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as B
from repro_torch.models.common import DTYPES, rms_norm, rope, rope_inv_freq
from repro_torch.models.config import BlockKind, ModelConfig

__all__ = ["Layer", "Transformer", "embed_inputs", "encode", "forward", "init_cache", "prefill",
           "decode_step"]

Cache = Dict[str, Any]

_ATTN_KINDS = (BlockKind.ATTN, BlockKind.ATTN_LOCAL, BlockKind.MOE, BlockKind.HYMBA,
               BlockKind.HYMBA_LOCAL)
_HYMBA = (BlockKind.HYMBA, BlockKind.HYMBA_LOCAL)
_LOCAL = (BlockKind.ATTN_LOCAL, BlockKind.HYMBA_LOCAL)
_XLSTM = (BlockKind.MLSTM, BlockKind.SLSTM)


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind in _LOCAL else None


def _local_theta(cfg: ModelConfig, window: Optional[int]) -> bool:
    """Whether a layer takes the sliding-window RoPE base (gemma3-style
    configs set ``rope_theta_local``)."""
    return window is not None and cfg.rope_theta_local is not None


class Layer(nn.Module):
    """One layer: ``norm1``, attention and/or SSD heads, ``norm2``, the MLP
    (the ``moe`` in an MoE layer); or, for the xLSTM kinds, ``norm1`` and the
    ``mlstm`` or ``slstm`` cell, which carries its own projections (no
    ``norm2``, no MLP). With ``cross`` (an encoder-decoder's decoder layer)
    also ``norm_cross`` and ``cross``; ``causal=False`` for the encoder's."""

    def __init__(self, cfg: ModelConfig, kind: str, g: Optional[torch.Generator], device=None,
                 *, cross: bool = False, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.causal = causal
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
        elif kind == BlockKind.MLSTM:
            self.mlstm = B.MLSTM(cfg, g, device)
        elif kind == BlockKind.SLSTM:
            self.slstm = B.SLSTM(cfg, g, device)
        else:  # pragma: no cover - ModelConfig refuses other kinds
            raise ValueError(kind)
        if kind == BlockKind.MOE:
            self.norm2 = zeros()
            self.moe = B.MoE(cfg, g, device)
        elif kind not in _XLSTM:
            self.norm2 = zeros()
            self.mlp = B.MLP(cfg, g, device)
        if cross:
            self.cross = B.CrossAttention(cfg, g, device)
            self.norm_cross = zeros()

    @property
    def cell(self) -> nn.Module:
        """The xLSTM layer's cell (``mlstm`` or ``slstm``)."""
        return self.mlstm if self.kind == BlockKind.MLSTM else self.slstm


class Transformer(nn.Module):
    """The model: ``embed [V, d]``, ``frontend_proj [frontend_dim, d]`` with
    a frontend, ``layers``, ``final_norm`` and ``lm_head [d, V]`` (the
    embedding's transpose when tied); an encoder-decoder also ``encoder``
    (its layers) and ``enc_final_norm``. Its RoPE inverse frequencies are
    buffers, so decode computes its tables on the device."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        g = generator
        dev = device if g is None else g.device
        dt = DTYPES[cfg.dtype]
        self.embed = B._new(g, (cfg.vocab_size, cfg.d_model), dt, dev, fan_in=cfg.d_model)
        self.final_norm = B._const((cfg.d_model,), 0.0, dev)
        if not cfg.tie_embeddings:
            self.lm_head = B._new(g, (cfg.d_model, cfg.vocab_size), dt, dev)
        if cfg.frontend:
            self.frontend_proj = B._new(g, (cfg.frontend_dim, cfg.d_model), dt, dev)
        self.layers = nn.ModuleList(Layer(cfg, kind, g, dev, cross=cfg.is_encdec)
                                    for kind in cfg.layer_kinds)
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(Layer(cfg, BlockKind.ATTN, g, dev, causal=False)
                                         for _ in range(cfg.encoder_layers))
            self.enc_final_norm = B._const((cfg.d_model,), 0.0, dev)
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
    if kind == BlockKind.MLSTM:
        c["cell"] = B.init_mlstm_cache(cfg, batch, device=device)
    if kind == BlockKind.SLSTM:
        c["cell"] = B.init_slstm_cache(cfg, batch, device=device)
    if cfg.is_encdec:
        shape = (batch, cfg.frontend_tokens or max_len, cfg.n_kv_heads, cfg.hd)
        c["cross_kv"] = {n: torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=device)
                         for n in ("k", "v")}
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Cache:
    """An empty cache for ``batch`` sequences of up to ``max_len`` tokens."""
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


def _ssd(layer: Layer, h: torch.Tensor, c: Optional[Cache]) -> torch.Tensor:
    """The layer's SSD heads over the sequence; with a cache (prefill) their
    state at its end goes to ``c["ssm"]``, and only then is it computed."""
    if c is None:
        return layer.mamba(h)
    y, c["ssm"] = layer.mamba.prefill(h)
    return y


def _ffn(layer: Layer, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(x + the layer's MLP or MoE of norm2(x), the MoE's aux or None)``."""
    h = rms_norm(x, layer.norm2, layer.cfg.norm_eps)
    if layer.kind == BlockKind.MOE:
        m, aux = layer.moe(h)
        return x + m, aux
    return x + layer.mlp(h), None


def _cross(layer: Layer, x: torch.Tensor, kv: Optional[Cache]) -> torch.Tensor:
    """``x`` plus the layer's cross-attention of ``norm_cross(x)`` over the
    encoder's keys and values ``kv`` (``x`` as it is without them: a layer
    of a config with no encoder)."""
    if kv is None:
        return x
    return x + layer.cross(rms_norm(x, layer.norm_cross, layer.cfg.norm_eps), kv)


def _block(layer: Layer, x: torch.Tensor, tables, c: Optional[Cache] = None,
           enc: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer over a whole sequence: ``(x, aux)``, aux the MoE's
    load-balance loss (None for the other kinds); with a cache ``c``
    (prefill) its keys, values and SSD or xLSTM state go there, and the
    keys and values of the encoder output ``enc`` (an encoder-decoder's)
    to ``c["cross_kv"]``."""
    cfg = layer.cfg
    h = rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.kind in _XLSTM:
        if c is None:
            return x + layer.cell(h), None
        y, c["cell"] = layer.cell.prefill(h)
        return x + y, None
    if layer.kind in _ATTN_KINDS:
        a, k, v = layer.attn(h, tables[_local_theta(cfg, layer.window)], window=layer.window,
                             causal=layer.causal)
        if c is not None:
            _write_kv(c["kv"], k, v)
        if layer.kind in _HYMBA:
            a = 0.5 * (a + _ssd(layer, h, c))
        kv = None if enc is None else layer.cross.kv(enc)
        if kv is not None and c is not None:
            c["cross_kv"] = kv
        return _ffn(layer, _cross(layer, x + a, kv))
    a = _ssd(layer, h, c)  # MAMBA
    return _ffn(layer, x + a)


# ===========================================================================
# frontends and the encoder
# ===========================================================================
def _project(params: Transformer, embeds: torch.Tensor) -> torch.Tensor:
    """Frontend embeddings ``[B, n, frontend_dim]`` cast to the embedding's
    dtype (bf16 rounds a float32 input first), times ``frontend_proj``."""
    return embeds.to(params.embed.device, params.embed.dtype) @ params.frontend_proj


def embed_inputs(params: Transformer, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings of ``batch["tokens"] [B, S]``; a vision config
    with ``batch["frontend_embeds"]`` prepends their projections and keeps
    the first ``S`` positions (the prompt's last tokens drop out), as the
    reference's ``embed_inputs``. Without them it runs on the tokens
    alone."""
    tokens = batch["tokens"].to(params.embed.device)
    x = params.embed[tokens]
    if cfg.frontend == "vision" and "frontend_embeds" in batch:
        x = torch.cat([_project(params, batch["frontend_embeds"]), x], dim=1)[:, :tokens.shape[1]]
    return x


def _run(layer: Layer, x: torch.Tensor, tables, remat: bool,
         enc: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`_block` without a cache, inside ``torch.utils.checkpoint``
    under ``remat``."""
    if remat:
        return checkpoint(_block, layer, x, tables, None, enc, use_reentrant=False)
    return _block(layer, x, tables, None, enc)


def encode(params: Transformer, batch: Dict[str, torch.Tensor],
           cfg: ModelConfig) -> Optional[torch.Tensor]:
    """An encoder-decoder's encoder output ``[B, Se, d]`` of
    ``batch["frontend_embeds"] [B, Se, frontend_dim]`` (None for other
    configs): projected, the encoder's layers without a causal mask over
    positions ``0..Se-1``, then ``enc_final_norm``."""
    if not cfg.is_encdec:
        return None
    if "frontend_embeds" not in batch:
        raise KeyError(f"{cfg.name} is an encoder-decoder: its batch needs 'frontend_embeds' "
                       f"[B, Se, {cfg.frontend_dim}] beside 'tokens'")
    e = _project(params, batch["frontend_embeds"])
    tables = params.rope_tables(torch.arange(e.shape[1], device=e.device))
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.encoder:
        e, _ = _run(layer, e, tables, remat)
    return rms_norm(e, params.enc_final_norm, cfg.norm_eps)


# ===========================================================================
# training forward
# ===========================================================================
def forward(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of ``batch["tokens"] [B, S]`` (and
    ``batch["frontend_embeds"]`` with a frontend): ``(logits [B, S, V],
    aux)``. ``aux`` is the sum of the MoE layers' load-balancing losses,
    float32 (0 without MoE layers)."""
    enc = encode(params, batch, cfg)
    x = embed_inputs(params, batch, cfg)
    tables = params.rope_tables(torch.arange(x.shape[1], device=x.device))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, a = _run(layer, x, tables, remat, enc)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head, aux


def prefill(params: Transformer, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt ``batch["tokens"] [B, S]`` (and
    ``batch["frontend_embeds"]`` with a frontend) through the model,
    filling ``cache`` in place: ``(last-position logits [B, V], cache)``."""
    enc = encode(params, batch, cfg)
    x = embed_inputs(params, batch, cfg)
    S = x.shape[1]
    tables = params.rope_tables(torch.arange(S, device=x.device))
    for layer, c in zip(params.layers, cache["layers"]):
        x, _ = _block(layer, x, tables, c, enc)
    cache["pos"] = S
    x = rms_norm(x[:, -1], params.final_norm, cfg.norm_eps)
    return x @ params.head, cache


# ===========================================================================
# decode
# ===========================================================================
def _block_decode(layer: Layer, x: torch.Tensor, c: Cache, pos: int, tables) -> torch.Tensor:
    cfg = layer.cfg
    h = rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.kind in _XLSTM:
        y, c["cell"] = layer.cell.decode(h, c["cell"])
        return x + y
    if layer.kind in _ATTN_KINDS:
        a = layer.attn.decode(h, c["kv"], tables[_local_theta(cfg, layer.window)], pos=pos)
        if layer.kind in _HYMBA:
            s, c["ssm"] = layer.mamba.decode(h, c["ssm"])
            a = 0.5 * (a + s)
        # cross-attention of the one query row: the flash forward at Sq = 1
        x = _cross(layer, (x + a)[:, None], c.get("cross_kv"))[:, 0]
    else:  # MAMBA
        a, c["ssm"] = layer.mamba.decode(h, c["ssm"])
        x = x + a
    if layer.kind == BlockKind.MOE:  # the token alone, a group of one: [B, 1, d]
        y, _ = _ffn(layer, x[:, None])
        return y[:, 0]
    return _ffn(layer, x)[0]


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
