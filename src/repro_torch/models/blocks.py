"""Layer blocks of the serving path: GQA attention (full or sliding
window, causal or not), cross-attention, the gated MLP, the mixture of experts, mamba-style SSD heads and
xLSTM's mLSTM and sLSTM cells, each with its full-sequence forward and its
one-token decode.

The port of the reference package's ``repro.models.blocks``. Each block is an ``nn.Module`` whose
parameters carry the reference's names (``wq``, ``w_gate``, ``w_in``,
``r_gates``, ...), so :mod:`repro_torch.convert` maps the reference's
pytree onto it.

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
  xLSTM's mLSTM the ``normalize=True`` case; both run on its kernels
  (:func:`repro_torch.kernels.ops.mlstm_chunk`);
- the sLSTM has no kernel, as the reference has none: its recurrence is a
  Python loop over positions in torch ops (the reference's ``lax.scan``);
- the MoE's expert products are plain batched matrix products (``einsum``
  over ``[B, E, C, d]`` buffers), as the reference leaves them to XLA;
- cross-attention (the encoder-decoder's) has no bias and no RoPE on either
  side: its keys and values are the encoder output's projections, computed
  once a prompt, and it runs on the flash forward without a causal mask, in
  decode too (one query row).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import DTYPES, apply_rope, dense_init, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = [
    "Attention",
    "CrossAttention",
    "MLP",
    "MoE",
    "MoERoute",
    "Mamba",
    "MLSTM",
    "SLSTM",
    "init_attention_cache",
    "init_mamba_cache",
    "init_mlstm_cache",
    "init_slstm_cache",
    "linear_cell_step",
    "final_linear_state",
]

Cache = Dict[str, torch.Tensor]
Tables = Tuple[torch.Tensor, torch.Tensor]  # rope (cos, sin)


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
        self, x: torch.Tensor, rope: Tables, *, window: Optional[int] = None,
        causal: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence attention (causal unless an encoder's): ``(y [B, S,
        d], k, v)`` with the post-RoPE keys and the values, which prefill
        writes to the cache."""
        B, S, _ = x.shape
        q, k, v = self.qkv(x)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out, _ = ops.flash_attention(q, k, v, causal=causal, window=window)
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


class CrossAttention(nn.Module):
    """A decoder layer's attention over the encoder's output: ``wq [d, H
    hd]``, ``wk``/``wv [d, Hkv hd]``, ``wo [H hd, d]``; no bias (even with
    ``qkv_bias``) and no RoPE, as the reference's ``init_attention(...,
    cross=True)`` and ``cross_attention_forward``."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.wq = _new(g, (d, H * hd), dt, device)
        self.wk = _new(g, (d, Hkv * hd), dt, device)
        self.wv = _new(g, (d, Hkv * hd), dt, device)
        self.wo = _new(g, (H * hd, d), dt, device)

    def kv(self, enc: torch.Tensor) -> Cache:
        """The encoder output ``enc [B, Se, d]``'s keys and values, ``{"k",
        "v"}`` of ``[B, Se, Hkv, hd]`` (what prefill keeps as ``cross_kv``)."""
        B, Se, _ = enc.shape
        shape = (B, Se, self.cfg.n_kv_heads, self.cfg.hd)
        return {"k": (enc @ self.wk).reshape(shape), "v": (enc @ self.wv).reshape(shape)}

    def forward(self, x: torch.Tensor, kv: Cache) -> torch.Tensor:
        """``x [B, S, d]`` (``S`` 1 in decode) attending to every key of
        ``kv``: ``[B, S, d]``."""
        B, S, _ = x.shape
        q = (x @ self.wq).reshape(B, S, self.cfg.n_heads, self.cfg.hd)
        out, _ = ops.flash_attention(q, kv["k"], kv["v"], causal=False)
        return out.reshape(B, S, -1) @ self.wo


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
    """SwiGLU MLP: ``w_gate``, ``w_up [d, ff]``, ``w_down [ff, d]``, ``ff``
    the config's ``d_ff`` unless ``d_ff`` is given (the MoE's shared
    experts)."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        dt = DTYPES[cfg.dtype]
        self.w_gate = _new(g, (d, ff), dt, device)
        self.w_up = _new(g, (d, ff), dt, device)
        self.w_down = _new(g, (ff, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


# ===========================================================================
# mixture of experts (capacity-based dispatch)
# ===========================================================================
class MoERoute(NamedTuple):
    """The router's choices for ``x [B, S, d]``, ``T = S * k`` (token, choice)
    pairs a sequence in token-major order."""

    gates: torch.Tensor    # [B, S, k] float32, renormalised to sum 1
    experts: torch.Tensor  # [B, S, k] int64, by descending probability
    rank: torch.Tensor     # [B, T] int64: the pair's place in its expert's queue
    keep: torch.Tensor     # [B, T] bool: rank < capacity (the rest are dropped)
    capacity: int
    aux: torch.Tensor      # [] float32 Switch-style load-balance loss


class MoE(nn.Module):
    """Top-k routed experts with a per-sequence capacity, plus shared
    experts behind a sigmoid gate: ``router [d, E]`` (float32), ``w_gate``,
    ``w_up [E, d, ffe]``, ``w_down [E, ffe, d]``, and with
    ``n_shared_experts``, ``shared`` (an :class:`MLP` of ``n_shared * ffe``)
    and ``shared_gate [d, 1]``.

    The port of the reference's ``moe_forward``. Its two lowerings
    (``moe_dispatch`` "onehot" and "sort") drop the same pairs: a pair's
    rank in its expert's queue follows the flattened token-major ``S * k``
    order in both (the one-hot cumsum, the stable argsort). The port
    computes that function once, by index: each kept pair's token is
    gathered into its slot of ``[B, E, C, d]``, the experts run on the
    buffers as batched products (empty slots are zero rows, which the gated
    MLP maps to zero), each pair's result is gathered back and weighted by
    its gate. The k weighted results of a token are summed in float32 and
    rounded once to the model's dtype, as the one-hot combine does (its
    gates rounded to that dtype first); the sort lowering adds them in the
    model's dtype, which differs in bf16 by that dtype's rounding."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        ffe = cfg.d_ff_expert or cfg.d_ff
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.router = _new(g, (d, E), torch.float32, device)
        self.w_gate = _new(g, (E, d, ffe), dt, device, fan_in=d)
        self.w_up = _new(g, (E, d, ffe), dt, device, fan_in=d)
        self.w_down = _new(g, (E, ffe, d), dt, device, fan_in=ffe)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, g, device, d_ff=cfg.n_shared_experts * ffe)
            self.shared_gate = _new(g, (d, 1), dt, device)

    def route(self, x: torch.Tensor) -> MoERoute:
        """Softmax over the experts in float32, the top k renormalised, each
        pair's rank in its expert's queue, and the load-balance loss."""
        B, S, _ = x.shape
        E, k = self.cfg.n_experts, self.cfg.n_experts_active
        probs = torch.softmax(x.to(torch.float32) @ self.router, dim=-1)  # [B, S, E]
        # the top k by a stable descending sort: on exact ties the lower
        # expert first, as jax.lax.top_k takes them (torch.topk promises no
        # order among ties)
        vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = vals[..., :k], order[..., :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        flat = experts.reshape(B, S * k)
        onehot = F.one_hot(flat, E)  # [B, T, E]
        rank = (torch.cumsum(onehot, dim=1) - onehot).gather(2, flat[..., None])[..., 0]
        # the slots an expert takes from one sequence, as the reference
        # computes them (Python's round, half to even)
        capacity = int(max(1, round(S * k * self.cfg.moe_capacity_factor / E)))
        density = onehot.sum((0, 1)).to(torch.float32) / (B * S)
        aux = E * torch.sum(density * probs.mean(dim=(0, 1)))
        return MoERoute(gates, experts, rank, rank < capacity, capacity, aux)

    def experts(self, h: torch.Tensor) -> torch.Tensor:
        """``[B, E, C, d]`` -> ``[B, E, C, d]``: each expert's gated MLP on its
        buffer."""
        a = torch.einsum("becd,edf->becf", h, self.w_gate)
        u = torch.einsum("becd,edf->becf", h, self.w_up)
        return torch.einsum("becf,efd->becd", F.silu(a) * u, self.w_down)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, S, d]`` -> ``(out [B, S, d], aux)``; a decode step passes
        ``[B, 1, d]``, each sequence its own group."""
        B, S, d = x.shape
        E, k = self.cfg.n_experts, self.cfg.n_experts_active
        r = self.route(x)
        C = r.capacity
        slot = r.experts.reshape(B, S * k) * C + r.rank  # [B, T]
        rows = torch.arange(B, device=x.device)[:, None]
        # the token in every buffer slot, S (a zero row) where none; the
        # dropped pairs all go to slot E C, cut off after
        src = torch.full((B, E * C + 1), S, dtype=torch.int64, device=x.device)
        tok = torch.arange(S * k, device=x.device).div(k, rounding_mode="floor")
        src.scatter_(1, torch.where(r.keep, slot, E * C), tok.expand(B, -1))
        padded = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)
        buf = padded[rows, src[:, :E * C]].view(B, E, C, d)
        y = self.experts(buf).reshape(B, E * C, d)
        back = y[rows, torch.where(r.keep, slot, 0)].view(B, S, k, d)
        w = (r.gates.reshape(B, S * k) * r.keep).to(x.dtype).view(B, S, k)
        out = torch.einsum("bsk,bskd->bsd", w.to(torch.float32),
                           back.to(torch.float32)).to(x.dtype)
        if self.cfg.n_shared_experts:
            out = out + self.shared(x) * torch.sigmoid(x @ self.shared_gate)
        return out, r.aux


# ===========================================================================
# the matrix-memory cell: mamba-style SSD heads (hymba's SSM half) and
# xLSTM's mLSTM
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
        return _finish(self, y, z)

    def _heads(self, x: torch.Tensor):
        """``(y [B, S, d], (k, v, log_inject, log_decay))`` of the heads over
        ``x [B, S, d]`` on the chunkwise cell (``normalize=False``, unit
        scale)."""
        B, S, _ = x.shape
        _, z, kb, qc, vv, li, lf = self.project(x)
        y = ops.mlstm_chunk(qc, kb, vv, li, lf, normalize=False, scale=1.0)
        return self.finish(y.reshape(B, S, -1), z), (kb, vv, li, lf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SSD heads over a whole sequence ``x [B, S, d]``: ``y [B, S, d]``
        (the reference's ``mamba_forward``; training computes no state)."""
        return self._heads(x)[0]

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """:meth:`forward` and the state at the sequence's end, in closed
        form: ``(y [B, S, d], state)``, for a prompt's cache."""
        y, (kb, vv, li, lf) = self._heads(x)
        return y, final_linear_state(kb, vv, li, lf, normalize=False)

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


def _finish(block: nn.Module, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Group-norm a cell's heads' output ``y [..., di]``, gate it by
    ``silu(z)`` and project out (SSD heads and the mLSTM alike)."""
    y = rms_norm(y, block.gn_scale, block.cfg.norm_eps)
    return (y * F.silu(z)) @ block.w_out


class MLSTM(nn.Module):
    """xLSTM's matrix-memory block: ``w_in [d, 2 di]`` (x and the gate z),
    ``wq``/``wk``/``wv [di, di]``, float32 ``w_igate``/``w_fgate [di, H]``,
    ``b_fgate [H]`` (3.0: the forget gate starts open) and ``gn_scale
    [di]``, ``w_out [di, d]``; ``di = ssm_expand d``, every head ``di / H``
    wide in q, k and v."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        H = cfg.n_heads
        dt = DTYPES[cfg.dtype]
        f32 = torch.float32
        self.cfg = cfg
        self.w_in = _new(g, (d, 2 * di), dt, device)
        self.wq = _new(g, (di, di), dt, device)
        self.wk = _new(g, (di, di), dt, device)
        self.wv = _new(g, (di, di), dt, device)
        self.w_igate = _new(g, (di, H), f32, device)
        self.w_fgate = _new(g, (di, H), f32, device)
        dev = self.w_in.device
        self.b_fgate = _const((H,), 3.0, dev)
        self.w_out = _new(g, (di, d), dt, device)
        self.gn_scale = _const((di,), 0.0, dev)

    def project(self, x: torch.Tensor):
        """``x [..., d]`` -> ``(z, q, k, v, i_gate, f_gate)``: q, k, v
        ``[..., H, di/H]`` in the compute dtype, the gates' float32
        pre-activations ``[..., H]``."""
        cfg = self.cfg
        H = cfg.n_heads
        di = cfg.ssm_expand * cfg.d_model
        xc, z = torch.split(x @ self.w_in, di, dim=-1)
        heads = lambda w: (xc @ w).reshape(*x.shape[:-1], H, di // H)
        xf = xc.to(torch.float32)
        return (z, heads(self.wq), heads(self.wk), heads(self.wv),
                xf @ self.w_igate, xf @ self.w_fgate + self.b_fgate)

    def _cell(self, x: torch.Tensor):
        """``(y [B, S, d], (k, v, i_gate, f_gate))`` over ``x [B, S, d]`` on
        the chunkwise cell (``normalize=True``, scale ``(di/H) ** -0.5``)."""
        B, S, _ = x.shape
        z, q, k, v, ig, fg = self.project(x)
        y = ops.mlstm_chunk(q, k, v, ig, fg, normalize=True)
        return _finish(self, y.reshape(B, S, -1), z), (k, v, ig, fg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The block over a whole sequence ``x [B, S, d]``: ``y [B, S, d]``
        (the reference's ``mlstm_forward``)."""
        return self._cell(x)[0]

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """:meth:`forward` and the cell's state at the sequence's end, in
        closed form (the reference's ``_mlstm_prefill``)."""
        y, (k, v, ig, fg) = self._cell(x)
        return y, final_linear_state(k, v, ig, fg, normalize=True)

    def decode(self, x: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token ``x [B, d]``: ``(y [B, d], new state)``; q is scaled by
        ``(di/H) ** -0.5`` in the compute dtype before the step, as the
        reference's ``mlstm_decode`` scales it."""
        B = x.shape[0]
        z, q, k, v, ig, fg = self.project(x)
        q = q * q.shape[-1] ** -0.5
        y, new = linear_cell_step(q, k, v, ig, fg, cache, normalize=True)
        return _finish(self, y.reshape(B, -1).to(x.dtype), z), new


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device=None) -> Cache:
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    dh = di // H
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=f32, device=device),
    }


# ===========================================================================
# xLSTM's sLSTM (scalar memory, recurrent)
# ===========================================================================
class SLSTM(nn.Module):
    """xLSTM's scalar-memory block: ``w_gates [d, 4d]`` (the input's part of
    the i, f, z, o pre-activations), float32 ``r_gates [H, dh, 4 dh]`` (the
    block-diagonal recurrence, ``dh = d / H``) and ``b_gates [4d]``,
    ``w_out [d, d]`` and float32 ``gn_scale [d]``."""

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator], device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        dt = DTYPES[cfg.dtype]
        f32 = torch.float32
        self.cfg = cfg
        self.w_gates = _new(g, (d, 4 * d), dt, device)
        self.r_gates = _new(g, (H, dh, 4 * dh), f32, device, fan_in=dh)
        dev = self.w_gates.device
        self.b_gates = _const((4 * d,), 0.0, dev)
        self.w_out = _new(g, (d, d), dt, device)
        self.gn_scale = _const((d,), 0.0, dev)

    def cell(self, gx: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One step (the reference's ``_slstm_cell``): ``gx [B, 4d]``, the
        input's part of the pre-activations, and the state -> ``(h [B, d]
        float32, new state)``. The exponential forget gate is stabilised by
        ``m``."""
        B, d = cache["h"].shape
        H = self.cfg.n_heads
        h_prev = cache["h"].reshape(B, H, d // H)
        # the heads' recurrent terms [B, H, 4 dh] are flattened to [B, 4d]
        # and only then split into i, f, z, o along the last axis, as the
        # reference splits them (not a per-head, per-gate layout)
        rec = torch.bmm(h_prev.transpose(0, 1), self.r_gates).transpose(0, 1).reshape(B, 4 * d)
        pre = gx.to(torch.float32) + rec + self.b_gates
        it, ft, zt, ot = torch.split(pre, d, dim=-1)
        m_new = torch.maximum(ft + cache["m"], it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + cache["m"] - m_new)
        c_new = f_g * cache["c"] + i_g * torch.tanh(zt)
        n_new = f_g * cache["n"] + i_g
        h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1e-6)
        return h_new, {"h": h_new, "c": c_new, "n": n_new, "m": m_new}

    def out(self, h: torch.Tensor) -> torch.Tensor:
        """Norm the hidden states ``h [..., d]`` (in the compute dtype) and
        project out."""
        return rms_norm(h, self.gn_scale, self.cfg.norm_eps) @ self.w_out

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """The block over a whole sequence ``x [B, S, d]`` by the recurrence,
        one position a step from the empty state: ``(y [B, S, d], the state
        at the sequence's end)`` (the reference's ``_slstm_prefill``)."""
        B, S, _ = x.shape
        gx = (x @ self.w_gates).to(torch.float32)  # [B, S, 4d], cast once for every step
        cache = init_slstm_cache(self.cfg, B, device=x.device)
        hs = []
        for t in range(S):
            h, cache = self.cell(gx[:, t], cache)
            hs.append(h)
        return self.out(torch.stack(hs, dim=1).to(x.dtype)), cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`prefill`'s output alone (the reference's ``slstm_forward``)."""
        return self.prefill(x)[0]

    def decode(self, x: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token ``x [B, d]``: ``(y [B, d], new state)``."""
        h, new = self.cell(x @ self.w_gates, cache)
        return self.out(h.to(x.dtype)), new


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device=None) -> Cache:
    shape, f32 = (batch, cfg.d_model), torch.float32
    return {
        "h": torch.zeros(shape, dtype=f32, device=device),
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.zeros(shape, dtype=f32, device=device),
        "m": torch.full(shape, -1e30, dtype=f32, device=device),
    }
