"""Dispatch of the grid-tick, SELU-MLP, attention and mLSTM operations by
device.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
and a CUDA tensor takes the hand-written kernel
(:mod:`repro_torch.kernels.grid_tick`, :mod:`~repro_torch.kernels.selu_mlp`,
:mod:`~repro_torch.kernels.flash_attention`,
:mod:`~repro_torch.kernels.decode_attention`,
:mod:`~repro_torch.kernels.mlstm_chunk`); there is no other switch and no
fallback from one to the other. Validation
mirrors the reference package's ``repro.kernels.ops``.

:func:`flash_attention` is differentiable through :class:`FlashAttention`:
its forward is the dispatch above and saves ``(q, k, v, out, lse)``, its
backward the plain :func:`ref.flash_attention_bwd` on a CPU tensor and the
dq and dk/dv kernels on a CUDA tensor, as the reference's custom VJP
``flash_attention_pallas`` runs its two Pallas backward kernels. All three
kernels take head dims up to 128; past that the forward already refuses.
:func:`decode_attention` has no backward kernel yet (ROADMAP A.12): on a CUDA
tensor it raises when grad mode is on and an input requires grad, rather
than return an output cut from the graph.

:func:`mlstm_chunk` is differentiable through :class:`MlstmChunk`, whose
forward is the dispatch above and whose backward,
:func:`ref.mlstm_chunk_bwd`, is written in torch ops and runs on both
devices: the VJP of the chunked form the kernel computes. No TPU kernel
computes this gradient either: the reference's ``mlstm_chunk_pallas`` has no
``custom_vjp``, and its training path differentiates the plain cell by XLA
autodiff. So the backward is not a fallback from a kernel; none exists.

:func:`selu_mlp` is differentiable through :class:`SeluMLP`, whose forward
is that dispatch and whose backward is written in torch ops (``torch.matmul``
for the products, SELU's derivative from the saved pre-activations). The
reference has no backward kernel either: its ``selu_mlp_pallas`` carries no
``custom_vjp``, and the classifier's gradient is XLA autodiff of the plain
expression, outside any Pallas kernel.

Float32 contractions of the plain version run at full precision
(``torch.backends.cuda.matmul.allow_tf32`` must stay False, its default):
the one-hot incidence products are exact only there.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

__all__ = [
    "grid_tick",
    "grid_tick_sums",
    "grid_tick_bank",
    "grid_tick_bank_fused",
    "grid_tick_bank_sums",
    "selu_mlp",
    "SeluMLP",
    "flash_attention",
    "FlashAttention",
    "decode_attention",
    "mlstm_chunk",
    "MlstmChunk",
]


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the port's ops run on cpu or cuda tensors, got {x.device}")
    return x.device.type


def grid_tick(
    active: torch.Tensor,  # [B, T]
    remaining: torch.Tensor,  # [B, T]
    keep_frac: torch.Tensor,  # [T] or [B, T]
    bg_load: torch.Tensor,  # [B, L]
    bandwidth: torch.Tensor,  # [L]
    leg_proc: torch.Tensor,  # [T, P]
    proc_link: torch.Tensor,  # [P, L]
    leg_link: torch.Tensor,  # [T, L]
    *,
    tables: Optional[ref.BankTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fair-share tick of ``B`` simulations of one campaign (shared
    incidences): ``(xfer [B, T], proc_xfer [B, P], link_xfer [B, L])``.

    ``keep_frac`` may be shared ``[T]`` or per simulation ``[B, T]``. Both
    versions read the incidences as ``tables`` (the campaign's
    :func:`ref.campaign_index_tables`, a bank of one scenario), derived
    from them when ``None``, and take every sum in the order of its lists:
    the plain :func:`ref.grid_tick_indexed` on the CPU, the bank's tick
    kernel at ``S = 1`` on the card.
    """
    if active.dim() != 2 or remaining.dim() != 2 or bg_load.dim() != 2:
        raise ValueError(
            "grid_tick: per-sim state must be [B, ...] — got active "
            f"{tuple(active.shape)}, remaining {tuple(remaining.shape)}, "
            f"bg_load {tuple(bg_load.shape)}"
        )
    if keep_frac.dim() not in (1, 2) or bandwidth.dim() != 1:
        raise ValueError(
            f"grid_tick: keep_frac must be [T] or [B, T] and bandwidth [L]: "
            f"{tuple(keep_frac.shape)}, {tuple(bandwidth.shape)}"
        )
    if leg_proc.dim() != 2 or proc_link.dim() != 2 or leg_link.dim() != 2:
        raise ValueError(
            "grid_tick: incidences must be shared [T, P] / [P, L] / [T, L] — "
            f"got {tuple(leg_proc.shape)}, {tuple(proc_link.shape)}, "
            f"{tuple(leg_link.shape)}"
        )
    if tables is None:
        tables = ref.campaign_index_tables(leg_proc, proc_link, leg_link)
    if _device_kind(active) == "cpu":
        return ref.grid_tick_indexed(
            active, remaining, keep_frac, bg_load, bandwidth, leg_proc, proc_link, tables,
        )
    from repro_torch.kernels import grid_tick as _k

    f32 = torch.float32
    return _k.grid_tick_cuda(
        active.to(f32).contiguous(), remaining.to(f32).contiguous(),
        keep_frac.to(f32).contiguous(), bg_load.to(f32).contiguous(),
        bandwidth.to(f32).contiguous(), tables,
    )


def grid_tick_sums(
    v: torch.Tensor,  # [B, T]
    tables: ref.BankTables,  # of one campaign
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(proc [B, P], link [B, L])`` of ``B`` per-leg rows of one
    campaign: each process's sum of ``v`` over its legs and each link's
    over its processes' sums, in the order of the campaign's lists
    (:func:`ref.bank_sums` at ``S = 1``), as the per-campaign leap step
    takes them."""
    if v.dim() != 2 or tables.shape[:2] != (1, v.shape[1]):
        raise ValueError(
            f"grid_tick_sums: v must be [B, T] and tables one campaign's of T legs: "
            f"got v {tuple(v.shape)}, tables for (S, T) = {tables.shape[:2]}"
        )
    if _device_kind(v) == "cpu":
        proc, link = ref.bank_sums(v[None], tables)
        return proc[0], link[0]
    from repro_torch.kernels import grid_tick as _k

    return _k.grid_tick_sums_cuda(v.to(torch.float32).contiguous(), tables)


def grid_tick_bank(
    active: torch.Tensor,  # [S, R, T]
    remaining: torch.Tensor,  # [S, R, T]
    keep_frac: torch.Tensor,  # [S, T] or [S, R, T]
    bg_load: torch.Tensor,  # [S, R, L]
    bandwidth: torch.Tensor,  # [S, L]
    leg_proc: torch.Tensor,  # [S, T, P]
    proc_link: torch.Tensor,  # [S, P, L]
    leg_link: torch.Tensor,  # [S, T, L]
    *,
    tables: Optional[ref.BankTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scenario-bank fair-share tick with per-scenario incidences:
    ``(xfer [S, R, T], proc_xfer [S, R, P], link_xfer [S, R, L])``.

    Per-sim state must carry the replica dim; ``keep_frac`` may be bank-wide
    ``[S, T]`` or per replica ``[S, R, T]``. Both versions read the
    incidences as ``tables`` (:func:`ref.bank_index_tables`), derived from
    them when ``None``, and take every sum in the order of its lists.
    """
    if active.dim() != 3 or remaining.dim() != 3 or bg_load.dim() != 3:
        raise ValueError(
            "grid_tick_bank: per-sim state must be [S(cenario), R(eplica), ...] "
            f"— got active {tuple(active.shape)}, remaining "
            f"{tuple(remaining.shape)}, bg_load {tuple(bg_load.shape)}"
        )
    if keep_frac.dim() not in (2, 3):
        raise ValueError(
            f"grid_tick_bank: keep_frac must be [S, T] or [S, R, T]: "
            f"{tuple(keep_frac.shape)}"
        )
    if bandwidth.dim() != 2:
        raise ValueError(
            f"grid_tick_bank: bandwidth must be [S, L]: {tuple(bandwidth.shape)}"
        )
    if leg_proc.dim() != 3 or proc_link.dim() != 3 or leg_link.dim() != 3:
        raise ValueError(
            "grid_tick_bank: incidence matrices must carry the scenario dim "
            f"([S, T, P] / [S, P, L] / [S, T, L]) — got {tuple(leg_proc.shape)}, "
            f"{tuple(proc_link.shape)}, {tuple(leg_link.shape)}"
        )
    s = active.shape[0]
    for name, arr in (
        ("remaining", remaining), ("keep_frac", keep_frac), ("bg_load", bg_load),
        ("bandwidth", bandwidth), ("leg_proc", leg_proc),
        ("proc_link", proc_link), ("leg_link", leg_link),
    ):
        if arr.shape[0] != s:
            raise ValueError(
                f"grid_tick_bank: {name} scenario dim {arr.shape[0]} != {s}"
            )
    if tables is None:
        tables = ref.bank_index_tables(leg_proc, proc_link, leg_link)
    if _device_kind(active) == "cpu":
        return ref.grid_tick_bank_indexed(
            active, remaining, keep_frac, bg_load, bandwidth, leg_proc, proc_link, tables,
        )
    from repro_torch.kernels import grid_tick as _k

    f32 = torch.float32
    return _k.grid_tick_bank_cuda(
        active.to(f32).contiguous(), remaining.to(f32).contiguous(),
        keep_frac.to(f32).contiguous(), bg_load.to(f32).contiguous(),
        bandwidth.to(f32).contiguous(), tables,
    )


def grid_tick_bank_sums(
    v: torch.Tensor,  # [S, R, T]
    tables: ref.BankTables,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(proc [S, R, P], link [S, R, L])``: each process's sum of ``v`` over
    its legs and each link's over its processes' sums, in the order of the
    tables' lists (:func:`ref.bank_sums`), as the leap step takes them."""
    if v.dim() != 3 or tables.shape[:2] != (v.shape[0], v.shape[2]):
        raise ValueError(
            f"grid_tick_bank_sums: v must be [S, R, T] with (S, T) = "
            f"{tables.shape[:2]}: got {tuple(v.shape)}"
        )
    if _device_kind(v) == "cpu":
        return ref.bank_sums(v, tables)
    from repro_torch.kernels import grid_tick as _k

    return _k.grid_tick_bank_sums_cuda(v.to(torch.float32).contiguous(), tables)


def _bank_noise_chain(
    n_links: int, key: torch.Tensor, window: int, draw: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-draw one window of background noise for the fused kernel:
    ``window`` replays of :func:`ref.bank_split_draw`, as ``noise [K, S, R,
    L]`` plus the key chain ``[K + 1, S, R, 2]`` (entry ``j`` is the key
    after ``j`` splits, so an element that ran ``j`` alive ticks resumes from
    ``chain[j]``). ``draw=False`` splits the keys and leaves the noise zero,
    for a bank whose every ``sigma`` is 0 (``sigma * noise`` is then 0)."""
    keys = [key]
    rows = []
    for _ in range(window):
        key, noise = ref.bank_split_draw(key, n_links, draw=draw)
        keys.append(key)
        rows.append(noise)
    return torch.stack(keys), torch.stack(rows)


def grid_tick_bank_fused(
    state: Tuple[torch.Tensor, ...],  # ref.BANK_WINDOW_STATE_FIELDS layout
    bg_mu: torch.Tensor,  # [S, 1, L] or [S, R, L]
    bg_sigma: torch.Tensor,  # [S, 1, L] or [S, R, L]
    release: torch.Tensor,  # [S, T] i32
    dep: torch.Tensor,  # [S, T] i32 (-1 = none)
    bg_period: torch.Tensor,  # [S, L] i32
    max_ticks: torch.Tensor,  # [S] i32
    keep_frac: torch.Tensor,  # [S, T] or [S, R, T]
    bandwidth: torch.Tensor,  # [S, L]
    leg_proc: torch.Tensor,  # [S, T, P]
    proc_link: torch.Tensor,  # [S, P, L]
    leg_link: torch.Tensor,  # [S, T, L]
    *,
    window: int,
    leap: bool = False,
    key: Optional[torch.Tensor] = None,  # [S, R, 2] carried keys
    noise: Optional[torch.Tensor] = None,  # [K, S, R, L] predrawn normals
    tables: Optional[ref.BankTables] = None,
    draw: Optional[bool] = None,  # any bg_sigma > 0 (key= mode)
):
    """``window`` fused simulation ticks (event leaps under ``leap``) of a
    scenario bank; ``state`` follows ``ref.BANK_WINDOW_STATE_FIELDS``.

    With ``key=`` the keys ride along and ``(state, key)`` returns; with
    ``noise=`` the pre-drawn rows are consumed and ``state`` returns.

    On CPU tensors this is the plain scan with its indexed tick. On CUDA
    tensors, tick mode is one launch of the fused kernel (the key chain and
    its noise drawn ahead, each element's key then resynchronised from its
    alive-step count); leap mode is the plain scan driving the one-tick
    kernel once per event step, as the reference's kernel path does, and
    the sums kernel once per event step for the sums of its last tick.

    ``tables`` (the incidences as index tables) and ``draw`` (whether any
    ``sigma`` is positive) are fixed for a bank: a caller that runs many
    windows passes them, else they are derived here on every call.
    """
    if len(state) != len(ref.BANK_WINDOW_STATE_FIELDS):
        raise ValueError(
            f"grid_tick_bank_fused: state must carry "
            f"{len(ref.BANK_WINDOW_STATE_FIELDS)} arrays "
            f"({', '.join(ref.BANK_WINDOW_STATE_FIELDS)}): got {len(state)}"
        )
    if window < 1:
        raise ValueError(f"grid_tick_bank_fused: window must be >= 1: {window}")
    if (key is None) == (noise is None):
        raise ValueError(
            "grid_tick_bank_fused: pass exactly one of key= or noise="
        )
    if noise is not None and (noise.dim() != 4 or noise.shape[0] != window):
        raise ValueError(
            f"grid_tick_bank_fused: noise must be [window={window}, S, R, L]: "
            f"{tuple(noise.shape)}"
        )
    if bg_mu.dim() != 3 or bg_sigma.dim() != 3:
        raise ValueError(
            "grid_tick_bank_fused: bg moments must be [S, 1, L] or "
            f"[S, R, L]: {tuple(bg_mu.shape)}, {tuple(bg_sigma.shape)}"
        )
    if tables is None:
        tables = ref.bank_index_tables(leg_proc, proc_link, leg_link)
    if key is not None and draw is None:
        draw = bool(torch.any(bg_sigma > 0))
    on_cpu = _device_kind(state[2]) == "cpu"
    if on_cpu or leap:
        tick = sums = None
        if not on_cpu:
            tick = functools.partial(grid_tick_bank, tables=tables)
            sums = functools.partial(grid_tick_bank_sums, tables=tables)
        return ref.grid_tick_bank_window(
            state, bg_mu, bg_sigma, release, dep, bg_period, max_ticks,
            keep_frac, bandwidth, leg_proc, proc_link, leg_link,
            leap=leap, tick=tick, key=key, noise=noise, window=window,
            tables=tables, draw=draw, sums=sums,
        )
    from repro_torch.kernels import grid_tick as _k

    S, R = state[0].shape
    L = bg_mu.shape[-1]
    chain = None
    if key is not None:
        chain, noise = _bank_noise_chain(L, key, window, draw=draw)
    # mu and sigma agree on their replica dim inside the kernel: if either
    # carries one, broadcast both
    if bg_mu.shape[1] != 1 or bg_sigma.shape[1] != 1:
        bg_mu = bg_mu.expand(S, R, L)
        bg_sigma = bg_sigma.expand(S, R, L)
    f32, i32 = torch.float32, torch.int32
    c = lambda x, dt: x.to(dt).contiguous()
    state = tuple(
        c(x, dt) for x, dt in zip(state, (i32, i32, f32, torch.bool, torch.bool,
                                          i32, i32, f32, f32, f32))
    )
    out = _k.grid_tick_bank_fused_cuda(
        state, c(noise, f32), c(bg_mu, f32), c(bg_sigma, f32),
        c(release, i32), c(dep, i32), c(bg_period, i32), c(max_ticks, i32),
        c(keep_frac, f32), c(bandwidth, f32), tables,
    )
    if chain is None:
        return out
    steps = out[1].long()
    key = torch.gather(chain, 0, steps[None, :, :, None].expand(1, S, R, 2))[0]
    return out, key


def _selu_mlp_forward(x, weights, biases, save_pre: bool):
    if _device_kind(x) == "cpu":
        if save_pre:
            return ref.selu_mlp(x, weights, biases, return_pre=True)
        return ref.selu_mlp(x, weights, biases), None
    from repro_torch.kernels import selu_mlp as _k

    f32 = torch.float32
    c = lambda t: t.detach().to(f32).contiguous()
    return _k.selu_mlp_cuda(
        c(x), [c(w) for w in weights], [c(b) for b in biases], save_pre=save_pre
    )


class SeluMLP(torch.autograd.Function):
    """``selu_mlp`` with a backward: inputs ``(x, w0..wD, b0..bD)``."""

    @staticmethod
    def forward(ctx, x, *params):
        d = len(params) // 2
        weights, biases = params[:d], params[d:]
        want_grad = any(ctx.needs_input_grad)
        out, pre = _selu_mlp_forward(x, weights, biases, want_grad)
        if want_grad:
            ctx.save_for_backward(x, pre, *weights)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, pre, *weights = ctx.saved_tensors
        depth = len(weights) - 1
        f32 = torch.float32
        g = grad_out.to(f32)
        gw, gb = [None] * (depth + 1), [None] * (depth + 1)
        for i in range(depth, -1, -1):
            h = x.to(f32) if i == 0 else ref.selu(pre[i - 1])
            gw[i] = h.transpose(0, 1) @ g
            gb[i] = g.sum(0)
            if i > 0 or ctx.needs_input_grad[0]:
                g = g @ weights[i].to(f32).transpose(0, 1)
            if i > 0:
                z = pre[i - 1]
                g = g * torch.where(
                    z > 0, ref.SELU_SCALE, ref.SELU_SCALE * ref.SELU_ALPHA * torch.exp(z)
                )
        gx = g if ctx.needs_input_grad[0] else None
        return (gx, *gw, *gb)


def selu_mlp(
    x: torch.Tensor,  # [N, F_in]
    weights: Tuple[torch.Tensor, ...],
    biases: Tuple[torch.Tensor, ...],
) -> torch.Tensor:
    """SELU MLP forward ``[N, f_out]`` (SELU on all layers but the last):
    the plain version on a CPU tensor, the CUDA kernel on a CUDA tensor,
    differentiable in ``x``, ``weights`` and ``biases`` either way."""
    if x.dim() != 2:
        raise ValueError(f"selu_mlp: x must be [N, F_in]: {tuple(x.shape)}")
    if len(weights) != len(biases):
        raise ValueError(
            f"selu_mlp: {len(weights)} weights but {len(biases)} biases"
        )
    return SeluMLP.apply(x, *weights, *biases)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a backward: inputs ``(q, k, v, causal,
    window, scale, q_offset)``, outputs ``(out, lse)``, ``lse`` not
    differentiable. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        if _device_kind(q) == "cpu":
            out, lse = ref.flash_attention(q, k, v, **kw)
        else:
            from repro_torch.kernels import flash_attention as _k

            q, k, v = q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
            out, lse = _k.flash_attention_cuda(q, k, v, **kw)
        ctx.mark_non_differentiable(lse)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.kw = kw
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if _device_kind(q) == "cpu":
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        else:
            from repro_torch.kernels import flash_attention as _k

            dq, dk, dv = _k.flash_attention_bwd_cuda(
                q, k, v, out, lse, dout.to(q.dtype).contiguous(), **ctx.kw)
        want = ctx.needs_input_grad
        return (dq if want[0] else None, dk if want[1] else None, dv if want[2] else None,
                None, None, None, None)


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA attention with causal / sliding-window masks: ``(out [B, Sq, Hq,
    D], lse [B, Hq, Sq])``. The plain quadratic form on a CPU tensor, the
    flash-attention kernel on a CUDA tensor; differentiable in ``q``, ``k``
    and ``v`` through :class:`FlashAttention` either way."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q must be [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]: "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    return FlashAttention.apply(q, k, v, causal, window, scale, q_offset)


def _no_backward(name: str, *xs: torch.Tensor) -> None:
    """Raise if a kernel without a backward would cut an input that
    requires grad out of the graph."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP A.12: the "
            "decode training path); run it under torch.no_grad() "
            "or on inputs that do not require grad"
        )


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per sequence against its KV cache, positions
    ``>= lengths[b]`` masked: ``[B, Hq, D]``. The plain version on a CPU
    tensor, the decode-attention kernel on a CUDA tensor."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"decode_attention: q must be [B, Hq, D] and the cache [B, S, Hkv, D]: "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    if _device_kind(q) == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    _no_backward("decode_attention", q, k_cache, v_cache)
    from repro_torch.kernels import decode_attention as _k

    return _k.decode_attention_cuda(
        q.contiguous(), k_cache.to(q.dtype).contiguous(), v_cache.to(q.dtype).contiguous(),
        lengths.to(torch.int32).contiguous(), scale=scale,
    )


def _mlstm_chunk_forward(q, k, v, i_gate, f_gate, *, chunk, eps, normalize, scale):
    if _device_kind(q) == "cpu":
        if q.shape[1] <= 256:
            return ref.mlstm_chunk(
                q, k, v, i_gate, f_gate, eps=eps, normalize=normalize, scale=scale
            )
        return ref.mlstm_chunk_chunked(
            q, k, v, i_gate, f_gate, chunk=chunk, eps=eps, normalize=normalize, scale=scale
        )
    from repro_torch.kernels import mlstm_chunk as _k

    f32 = torch.float32
    return _k.mlstm_chunk_cuda(
        q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(),
        i_gate.to(f32).contiguous(), f_gate.to(f32).contiguous(),
        chunk=chunk, eps=eps, normalize=normalize, scale=scale,
    )


class MlstmChunk(torch.autograd.Function):
    """:func:`mlstm_chunk` with a backward: inputs ``(q, k, v, i_gate,
    f_gate, chunk, eps, normalize, scale)``, output ``[B, S, H, Dv]``.

    The forward is the dispatch by device and saves its five tensor inputs
    when one of them needs a gradient. The backward is
    :func:`ref.mlstm_chunk_bwd` on either device (plain torch ops: cuBLAS
    products on the card, inside a ``mlstm_chunk_bwd`` profiler range), the
    VJP of the float32 chunked cell at the saved inputs; gradients come back
    in the inputs' dtypes (bf16 ``q, k, v`` on the card at full width,
    float32 gates). It does not model the bf16 kernel's rounding of its
    operands (:func:`ref.mlstm_chunk_tc`)."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk, eps, normalize, scale):
        kw = dict(chunk=chunk, eps=eps, normalize=normalize, scale=scale)
        out = _mlstm_chunk_forward(q, k, v, i_gate, f_gate, **kw)
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(q, k, v, i_gate, f_gate)
            ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        inputs = ctx.saved_tensors
        with torch.profiler.record_function("mlstm_chunk_bwd"):
            grads = ref.mlstm_chunk_bwd(*inputs, dout, **ctx.kw)
        return (*(g.to(x.dtype) if want else None
                  for g, x, want in zip(grads, inputs, ctx.needs_input_grad)),
                None, None, None, None)


def mlstm_chunk(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,  # [B, S, H, Dk]
    v: torch.Tensor,  # [B, S, H, Dv]
    i_gate: torch.Tensor,  # [B, S, H]
    f_gate: torch.Tensor,  # [B, S, H]
    *,
    chunk: int = 128,
    eps: float = 1e-6,
    normalize: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The chunkwise mLSTM (``normalize=True``) or SSD (``False``) cell:
    ``[B, S, H, Dv]``. On a CPU tensor the plain version in the form the
    reference's CPU path takes (the parallel form up to ``S = 256``, the
    chunked recurrence above); on a CUDA tensor the mLSTM kernels, at any
    ``Dk`` up to 512 (past 64, xLSTM's 512-wide heads, the tensor-core pair
    in bf16 and the Dk-tiled kernel in float32).
    Differentiable in all five inputs through :class:`MlstmChunk` either
    way."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(
            f"mlstm_chunk: q, k must be [B, S, H, Dk] and v [B, S, H, Dv]: "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if i_gate.shape != q.shape[:3] or f_gate.shape != q.shape[:3]:
        raise ValueError(
            f"mlstm_chunk: gates must be [B, S, H] = {tuple(q.shape[:3])}: "
            f"{tuple(i_gate.shape)}, {tuple(f_gate.shape)}"
        )
    return MlstmChunk.apply(q, k, v, i_gate, f_gate, chunk, eps, normalize, scale)
