"""Likelihood-free Markov chain Monte Carlo with approximate ratios.

The port of ``repro.core.mcmc``: Metropolis-Hastings over the simulator
setting ``theta`` in the unit box, where the intractable likelihood ratio
is the trained AALR classifier's logit (paper Section 5),

    log alpha = log r(x_true, theta') - log r(x_true, theta_t)

under a uniform prior (a bounds check). A conditional classifier is served
by a fixed scenario ``context`` row per chain.

The reference runs one ``lax.scan`` per chain and ``vmap``-s the chains.
Here every chain of a call (and, for ``AmortizedPosterior.theta_star_all``,
every scenario's chains) is one row of a batch, and each step is a handful
of tensor ops and one ``selu_mlp`` launch over all rows. A chain's random
draws do not depend on its state: step ``t`` takes key ``t`` of
``split(chain_key, burn_in + n_samples)``, splits it into ``(k1, k2)`` and
draws ``normal(k1, (d,))`` and ``uniform(k2)``. So the draws of a chunk of
steps are made ahead in one batched call, with the same keys in the same
order; the chain is identical to the reference's step by step.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.classifier import Params, _split
from repro_torch.kernels import ops

__all__ = [
    "MCMCResult",
    "run_chain",
    "run_chains",
    "run_chains_batched",
    "run_chain_adaptive",
    "posterior_mode",
    "gelman_rubin",
]

#: Pre-drawn (row x step) normals per chunk of steps.
_DRAW_BUDGET = 1 << 22


class MCMCResult(NamedTuple):
    samples: torch.Tensor  # [n_samples, theta_dim] (unit-box coordinates)
    accept_rate: torch.Tensor  # []
    log_ratios: torch.Tensor  # [n_samples]


def _step_keys(keys: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Keys ``start..stop-1`` of ``split(key, n)`` for every row of ``keys
    [M, 2]`` -> ``[M, stop - start, 2]`` (a partitionable split's key ``i``
    does not depend on ``n``)."""
    i = torch.arange(start, stop, dtype=torch.int64, device=keys.device)
    b1, b2 = prng.threefry2x32(keys[:, 0:1], keys[:, 1:2], i >> 32, i & 0xFFFFFFFF)
    return torch.stack([b1, b2], dim=-1)


@torch.no_grad()
def _chains(
    params: Params,
    x_rows: torch.Tensor,  # [M, x_dim]
    ctx_rows: Optional[torch.Tensor],  # [M, F] or None
    keys: torch.Tensor,  # [M, 2] one key per chain
    theta0: torch.Tensor,  # [M, d]
    *,
    n_samples: int,
    burn_in: int,
    step_size: Optional[float],  # None: Robbins-Monro adaptation in burn-in
    target: float = 0.44,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``M`` independent chains as one batch: ``(samples [M, n, d], accepts
    [M, n] bool, log_ratios [M, n])`` of the kept steps."""
    dev = x_rows.device
    M, d = theta0.shape
    total = burn_in + n_samples
    # the classifier's input rows [theta, x, context]; each step writes the
    # proposals into the theta columns and launches one forward over all rows
    parts = [theta0, x_rows] + ([] if ctx_rows is None else [ctx_rows])
    inp = torch.cat(parts, dim=-1).to(torch.float32)
    ws, bs = _split(params)
    ratio = lambda: ops.selu_mlp(inp, ws, bs)[:, 0]
    theta = theta0.to(torch.float32)
    lr = ratio()
    samples = torch.empty((M, n_samples, d), dtype=torch.float32, device=dev)
    accepts = torch.empty((M, n_samples), dtype=torch.bool, device=dev)
    lrs = torch.empty((M, n_samples), dtype=torch.float32, device=dev)
    adaptive = step_size is None
    if adaptive:
        log_step = prng.log(torch.full((M,), 0.05, dtype=torch.float32, device=dev))
        step = torch.exp(log_step)[:, None]
    else:
        step = torch.tensor(step_size, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=dev)
    chunk = max(1, min(total, _DRAW_BUDGET // max(M, 1)))
    for t0 in range(0, total, chunk):
        t1 = min(total, t0 + chunk)
        k = prng.split(_step_keys(keys, t0, t1), 2)  # [M, T, 2, 2]
        noise = prng.normal(k[..., 0, :], (d,))  # [M, T, d]
        log_u = prng.log(prng.uniform(k[..., 1, :], ()))  # [M, T]
        for t in range(t0, t1):
            prop = theta + step * noise[:, t - t0]
            in_prior = torch.all((prop > 0.0) & (prop < 1.0), dim=-1)
            inp[:, :d] = prop
            lr_prop = ratio()
            log_alpha = torch.where(in_prior, lr_prop - lr, neg_inf)
            accept = log_u[:, t - t0] < log_alpha
            theta = torch.where(accept[:, None], prop, theta)
            lr = torch.where(accept, lr_prop, lr)
            if adaptive and t < burn_in:
                acc_p = torch.exp(torch.clamp(log_alpha, max=0.0))
                gamma = 0.66 / torch.pow(torch.tensor(1.0 + t, dtype=torch.float32), 0.6)
                log_step = log_step + gamma.to(dev) * (acc_p - target)
                step = torch.exp(log_step)[:, None]
            if t >= burn_in:
                samples[:, t - burn_in] = theta
                accepts[:, t - burn_in] = accept
                lrs[:, t - burn_in] = lr
    return samples, accepts, lrs


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 mean as ``jnp.mean`` rounds it: the sum times ``1 / n``."""
    inv = torch.tensor(1.0 / x.shape[dim], dtype=torch.float32, device=x.device)
    return x.to(torch.float32).sum(dim) * inv


def _theta_dim(params: Params, x_dim: int, ctx_dim: int) -> int:
    return params["w0"].shape[0] - x_dim - ctx_dim


def _single(params, x_true_unit, key, n_samples, burn_in, step_size, init, context):
    dev = params["w0"].device
    x = x_true_unit.to(dev)
    ctx = None if context is None else context.to(dev)[None]
    d = 3 if init is None else init.shape[-1]
    theta0 = torch.full((1, d), 0.5, device=dev) if init is None else init.to(dev)[None]
    s, a, lr = _chains(
        params, x[None], ctx, key.to(dev)[None], theta0,
        n_samples=n_samples, burn_in=burn_in, step_size=step_size,
    )
    return MCMCResult(samples=s[0], accept_rate=_mean(a[0], 0), log_ratios=lr[0])


def run_chain(
    params: Params,  # classifier params
    x_true_unit: torch.Tensor,  # [x_dim] observation projected to (0,1)
    key: torch.Tensor,
    *,
    n_samples: int = 10_000,
    burn_in: int = 1_000,
    step_size: float = 0.05,
    init: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
) -> MCMCResult:
    """One Metropolis-Hastings chain in the unit-box theta space, started
    at ``init`` (default the middle of the prior box), on the device of
    ``params``."""
    return _single(params, x_true_unit, key, n_samples, burn_in, step_size, init, context)


def run_chain_adaptive(
    params: Params,
    x_true_unit: torch.Tensor,
    key: torch.Tensor,
    *,
    n_samples: int = 10_000,
    burn_in: int = 1_000,
    init: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
) -> MCMCResult:
    """Metropolis-Hastings with Robbins-Monro step-size adaptation toward a
    0.44 acceptance rate during burn-in, frozen afterwards."""
    return _single(params, x_true_unit, key, n_samples, burn_in, None, init, context)


def run_chains_batched(
    params: Params,
    x_true_unit: torch.Tensor,  # [S, x_dim] one observation per chain set
    keys: torch.Tensor,  # [S, 2] one key per chain set
    *,
    n_chains: int = 8,
    n_samples: int = 10_000,
    burn_in: int = 1_000,
    step_size: float = 0.05,
    adaptive: bool = False,
    context: Optional[torch.Tensor] = None,  # [S, F] or None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``S`` independent :func:`run_chains` calls as one batch of ``S *
    n_chains`` rows: set ``i`` is ``run_chains(params, x_true_unit[i],
    keys[i], context=context[i])``. Returns ``(samples [S, C, n, d],
    accept_rate [S], log_ratios [S, C, n], rhat [S, d])``."""
    dev = params["w0"].device
    S = keys.shape[0]
    C = n_chains
    x = x_true_unit.to(dev)
    ctx_dim = 0 if context is None else context.shape[-1]
    d = _theta_dim(params, x.shape[-1], ctx_dim)
    k = prng.split(keys.to(dev), C + 1)  # [S, C + 1, 2]
    inits = prng.uniform(k[:, 0], (C, d), 0.2, 0.8)  # [S, C, d]
    rep = lambda a: a[:, None].expand(S, C, a.shape[-1]).reshape(S * C, a.shape[-1])
    ctx_rows = None if context is None else rep(context.to(dev).to(torch.float32))
    samples, accepts, lrs = _chains(
        params, rep(x), ctx_rows, k[:, 1:].reshape(S * C, 2), inits.reshape(S * C, d),
        n_samples=n_samples, burn_in=burn_in,
        step_size=None if adaptive else step_size,
    )
    samples = samples.reshape(S, C, n_samples, d)
    # per-chain rates, then their mean, as the reference pools its chains
    rate = _mean(_mean(accepts.reshape(S, C, n_samples), 2), 1)
    return samples, rate, lrs.reshape(S, C, n_samples), gelman_rubin(samples)


def run_chains(
    params: Params,
    x_true_unit: torch.Tensor,
    key: torch.Tensor,
    *,
    n_chains: int = 8,
    n_samples: int = 10_000,
    burn_in: int = 1_000,
    step_size: float = 0.05,
    adaptive: bool = False,
    context: Optional[torch.Tensor] = None,
) -> Tuple[MCMCResult, torch.Tensor]:
    """Independent chains from dispersed starts (uniform on [0.2, 0.8)).
    Returns the pooled result and the split-R-hat per dimension."""
    samples, rate, lrs, rhat = run_chains_batched(
        params, x_true_unit[None], key[None], n_chains=n_chains,
        n_samples=n_samples, burn_in=burn_in, step_size=step_size,
        adaptive=adaptive, context=None if context is None else context[None],
    )
    d = samples.shape[-1]
    return MCMCResult(
        samples=samples[0].reshape(-1, d),
        accept_rate=rate[0],
        log_ratios=lrs[0].reshape(-1),
    ), rhat[0]


def gelman_rubin(chain_samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per theta dimension of ``[..., n_chains, n_samples,
    dim]`` samples (values near 1.0 say the chains mixed)."""
    *lead, c, n, d = chain_samples.shape
    half = n // 2
    split = chain_samples[..., : 2 * half, :].reshape(*lead, 2 * c, half, d)
    chain_means = split.mean(dim=-2)  # [..., m, d]
    chain_vars = split.var(dim=-2, correction=1)
    w = chain_vars.mean(dim=-2)  # within-chain
    b = half * chain_means.var(dim=-2, correction=1)  # between-chain
    var_hat = (half - 1) / half * w + b / half
    return torch.sqrt(var_hat / torch.clamp(w, min=1e-12))


def posterior_mode(samples: torch.Tensor, n_bins: int = 50) -> torch.Tensor:
    """Per-axis histogram mode of ``[..., n, d]`` samples over ``[0, 1]``
    (the paper's theta*), binned exactly as ``jnp.histogram(col, n_bins,
    range=(0, 1))`` bins: a sample goes to the bin found by searching the
    float32 edges ``arange(n_bins + 1) * (1 / n_bins)`` (right side), the
    last edge into the last bin, values outside dropped; the first fullest
    bin wins. Returns ``[..., d]`` bin centres."""
    dev = samples.device
    f32 = torch.float32
    edges = torch.arange(n_bins + 1, dtype=f32, device=dev) * torch.tensor(1.0 / n_bins, dtype=f32)
    cols = samples.to(f32).transpose(-1, -2).contiguous()  # [..., d, n]
    idx = torch.searchsorted(edges, cols, right=True)
    idx = torch.where(cols == edges[-1], n_bins, idx)  # bin slot + 1
    inside = (idx >= 1) & (idx <= n_bins)
    counts = torch.zeros(cols.shape[:-1] + (n_bins + 2,), dtype=torch.int64, device=dev)
    counts.scatter_add_(-1, idx, inside.to(torch.int64))
    i = torch.argmax(counts[..., 1:n_bins + 1], dim=-1)
    return 0.5 * (edges[i] + edges[i + 1])
