"""Layer blocks of the serving path: GQA attention (full or sliding
window), the gated MLP and mamba-style SSD heads, each with its
full-sequence forward and its one-token decode.

The port of the attention, MLP and SSD parts of the reference package's
``repro.models.blocks``. Each block is an ``nn.Module`` whose parameters
carry the reference's names (``wq``, ``w_gate``, ``w_in``, ...), so
:mod:`repro_torch.convert` maps the reference's pytree onto it.

Every parameter is trainable (``requires_grad``), as every leaf of the
reference's parameter tree is differentiated by its train step; the serving
steps run under ``torch.no_grad()``.

Conventions, as in the reference:

- full-sequence forwards take ``x [B, S, d]``, decode steps ``x [B, d]``
  and a cache dict, which they update in place (the KV ring slot) or whose
  entries they replace (the SSD state);
- the compute dtype is the config dtype (bf16 by default); norms, gates and
  states run in float32, and each cast stands where the reference's result
  dtype puts it (JAX promotes ``bf16 op f32`` on its own, PyTorch does not);
- SSD heads are the ``normalize=False`` case of the chunkwise mLSTM cell and
  run on its kernel (:func:`repro_torch.kernels.ops.mlstm_chunk`).

MoE, the xLSTM cells (mLSTM, sLSTM), cross-attention and the modality
frontends are not ported yet (ROADMAP A.12): :func:`unported` names them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import DTYPES, apply_rope, dense_init, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = [
    "Attention",
    "MLP",
    "Mamba",
    "init_attention_cache",
    "init_mamba_cache",
    "linear_cell_step",
    "final_linear_state",
    "unported",
]

Cache = Dict[str, torch.Tensor]
Tables = Tuple[torch.Tensor, torch.Tensor]  # rope (cos, sin)


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A.12: the LLM "
        "substrate's MoE, xLSTM, encoder-decoder and frontend blocks)"
    )


def _new(g: Optional[torch.Generator], shape, dtype, device, fan_in=None) -> nn.Parameter:
    """A trainable parameter: :func:`dense_init` from ``g``, or uninitialised
    storage when ``g`` is None (a caller that loads weights next)."""
    t = torch.empty(shape, dtype=dtype, device=device) if g is None else dense_init(
        g, shape, dtype, fan_in)
    return nn.Parameter(t)


def _const(shape, value: float, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ===========================================================================
# attention
# ===========================================================================
class Attention(nn.Module):
    """GQA attention: ``wq [d, H hd]``, ``wk``/``wv [d, Hkv hd]``, ``wo [H hd,
    d]`` (and ``bq``/``bk``/``bv`` with ``qkv_bias``)."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.wq = _new(g, (d, H * hd), dt, device)
        self.wk = _new(g, (d, Hkv * hd), dt, device)
        self.wv = _new(g, (d, Hkv * hd), dt, device)
        self.wo = _new(g, (H * hd, d), dt, device)
        if cfg.qkv_bias:
            dev = self.wq.device
            self.bq = _const((H * hd,), 0.0, dev, dt)
            self.bk = _const((Hkv * hd,), 0.0, dev, dt)
            self.bv = _const((Hkv * hd,), 0.0, dev, dt)

    def qkv(self, x: torch.Tensor):
        """``x [B, S, d]`` -> q ``[B, S, H, hd]``, k, v ``[B, S, Hkv, hd]``."""
        B, S, _ = x.shape
        cfg = self.cfg
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return (q.reshape(B, S, cfg.n_heads, cfg.hd),
                k.reshape(B, S, cfg.n_kv_heads, cfg.hd),
                v.reshape(B, S, cfg.n_kv_heads, cfg.hd))

    def forward(
        self, x: torch.Tensor, rope: Tables, *, window: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence causal attention: ``(y [B, S, d], k, v)`` with the
        post-RoPE keys and the values, which prefill writes to the cache."""
        B, S, _ = x.shape
        q, k, v = self.qkv(x)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out, _ = ops.flash_attention(q, k, v, causal=True, window=window)
        return out.reshape(B, S, -1) @ self.wo, k, v

    def decode(self, x: torch.Tensor, cache: Cache, rope: Tables, *, pos: int) -> torch.Tensor:
        """One token ``x [B, d]`` at position ``pos``: its post-RoPE key and
        value go to ring slot ``pos % size`` of ``cache`` (in place), then it
        attends to the ``min(pos + 1, size)`` valid slots."""
        B, _ = x.shape
        q, k, v = self.qkv(x[:, None, :])
        cos, sin = rope
        q = apply_rope(q, cos, sin)[:, 0]  # [B, H, hd]
        k = apply_rope(k, cos, sin)[:, 0]  # [B, Hkv, hd]
        size = cache["k"].shape[1]
        slot = pos % size  # keys are stored post-RoPE: slot order is free
        cache["k"][:, slot] = k
        cache["v"][:, slot] = v[:, 0]
        lengths = torch.full((B,), min(pos + 1, size), dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q, cache["k"], cache["v"], lengths)
        return out.reshape(B, -1) @ self.wo


def init_attention_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, window: Optional[int] = None, device=None
) -> Cache:
    """Ring-buffer KV cache: sliding-window layers hold only the window."""
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    dt = DTYPES[cfg.dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ===========================================================================
# gated MLP
# ===========================================================================
class MLP(nn.Module):
    """SwiGLU MLP: ``w_gate``, ``w_up [d, ff]``, ``w_down [ff, d]``."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = DTYPES[cfg.dtype]
        self.w_gate = _new(g, (d, ff), dt, device)
        self.w_up = _new(g, (d, ff), dt, device)
        self.w_down = _new(g, (ff, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


# ===========================================================================
# mamba-style SSD heads (hymba's SSM half)
# ===========================================================================
def linear_cell_step(q, k, v, li, lf, cache: Cache, *, normalize: bool, eps: float = 1e-6):
    """One recurrent step of the stabilised matrix-memory cell (the
    reference's ``_linear_cell_step``): ``q, k, v [B, H, d*]``, gate
    pre-activations ``li, lf [B, H]`` -> ``(out [B, H, Dv] float32, new
    cache)``. ``normalize=False`` is SSD: ``lf`` is the raw log-decay."""
    C, n, m = cache["C"], cache["n"], cache["m"]
    if normalize:
        lfs = F.logsigmoid(lf)
        m_new = torch.maximum(lfs + m, li)
    else:
        lfs = lf
        m_new = torch.zeros_like(m)
    decay = torch.exp(lfs + m - m_new)[..., None, None]
    inject = torch.exp(li - m_new)[..., None, None]
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    C_new = decay * C + inject * kf[..., :, None] * vf[..., None, :]
    n_new = decay[..., 0] * n + inject[..., 0] * kf
    num = torch.einsum("bhd,bhdv->bhv", qf, C_new)
    if normalize:
        dot = torch.einsum("bhd,bhd->bh", qf, n_new)
        out = num / (torch.maximum(dot.abs(), torch.exp(-m_new)) + eps)[..., None]
    else:
        out = num
    return out, {"C": C_new, "n": n_new, "m": m_new}


def final_linear_state(k, v, li, lf, *, normalize: bool) -> Dict[str, torch.Tensor]:
    """Closed-form final ``(C, n, m)`` of the linear cell after a whole
    sequence (the reference's ``_final_linear_state``): ``k [B, S, H, Dk]``,
    ``v [B, S, H, Dv]``, gates ``[B, S, H]``."""
    lfs = F.logsigmoid(lf) if normalize else lf
    Fc = torch.cumsum(lfs, dim=1)
    w = Fc[:, -1:] - Fc + li  # decay of each position to the sequence's end
    if normalize:
        m = torch.amax(w, dim=1)
        wexp = torch.exp(w - m[:, None])
    else:
        m = torch.zeros(w.shape[:1] + w.shape[2:], dtype=torch.float32, device=w.device)
        wexp = torch.exp(w)
    kw = wexp[..., None] * k.to(torch.float32)
    C = torch.einsum("bshd,bshe->bhde", kw, v.to(torch.float32))
    return {"C": C, "n": kw.sum(dim=1), "m": m}


class Mamba(nn.Module):
    """SSD heads: ``w_in [d, 2 di]`` (x and the gate z), ``w_B``/``w_C [di, H
    N]`` (the k and q roles), float32 ``w_dt [di, H]``, ``b_dt``, ``a_log``
    ``[H]`` and ``gn_scale [di]``, ``w_out [di, d]``; ``di = ssm_expand d``,
    ``N = ssm_state``, head width ``di / H`` (the v role)."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        H, N = cfg.n_heads, cfg.ssm_state
        dt = DTYPES[cfg.dtype]
        f32 = torch.float32
        self.cfg = cfg
        self.w_in = _new(g, (d, 2 * di), dt, device)
        self.w_B = _new(g, (di, H * N), dt, device)
        self.w_C = _new(g, (di, H * N), dt, device)
        self.w_dt = _new(g, (di, H), f32, device)
        dev = self.w_in.device
        self.b_dt = _const((H,), -2.0, dev)
        self.a_log = _const((H,), 0.0, dev)
        self.w_out = _new(g, (di, d), dt, device)
        self.gn_scale = _const((di,), 0.0, dev)

    def gates(self, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(log_decay, log_inject)`` in float32 from the mamba
        parameterisation: ``dt = softplus(xc w_dt + b_dt)``, decay
        ``exp(-dt exp(a_log))``, injection ``dt``."""
        dt = F.softplus(xc.to(torch.float32) @ self.w_dt + self.b_dt)
        return -dt * torch.exp(self.a_log), torch.log(dt + 1e-9)

    def project(self, x: torch.Tensor):
        """``x [..., d]`` -> ``(xc, z, k, q, v, log_inject, log_decay)`` with
        the head dims split out: k, q ``[..., H, N]``, v ``[..., H, di/H]``."""
        cfg = self.cfg
        H, N = cfg.n_heads, cfg.ssm_state
        di = cfg.ssm_expand * cfg.d_model
        xc, z = torch.split(x @ self.w_in, di, dim=-1)
        lead = x.shape[:-1]
        kb = (xc @ self.w_B).reshape(*lead, H, N)
        qc = (xc @ self.w_C).reshape(*lead, H, N)
        vv = xc.reshape(*lead, H, di // H)
        log_decay, log_inject = self.gates(xc)
        return xc, z, kb, qc, vv, log_inject, log_decay

    def finish(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Group-norm the heads' output ``y [..., di]``, gate it by
        ``silu(z)`` and project out."""
        y = rms_norm(y, self.gn_scale, self.cfg.norm_eps)
        return (y * F.silu(z)) @ self.w_out

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """SSD heads over a whole sequence ``x [B, S, d]`` on the chunkwise
        kernel (``normalize=False``, unit scale): ``(y [B, S, d], state at
        its end)``, the state in closed form."""
        B, S, _ = x.shape
        _, z, kb, qc, vv, li, lf = self.project(x)
        y = ops.mlstm_chunk(qc, kb, vv, li, lf, normalize=False, scale=1.0)
        state = final_linear_state(kb, vv, li, lf, normalize=False)
        return self.finish(y.reshape(B, S, -1), z), state

    def decode(self, x: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token ``x [B, d]``: ``(y [B, d], new state)``."""
        B = x.shape[0]
        _, z, kb, qc, vv, li, lf = self.project(x)
        y, new = linear_cell_step(qc, kb, vv, li, lf, cache, normalize=False)
        return self.finish(y.reshape(B, -1).to(x.dtype), z), new


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device=None) -> Cache:
    di = cfg.ssm_expand * cfg.d_model
    H, N = cfg.n_heads, cfg.ssm_state
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, N, di // H), dtype=f32, device=device),
        "n": torch.zeros((batch, H, N), dtype=f32, device=device),
        "m": torch.zeros((batch, H), dtype=f32, device=device),
    }
