"""No-intercept OLS regression and the paper's evaluation statistics.

The port of ``repro.core.regression``: the paper fits ``T = 0 + a*S +
b*ConTh + c*ConPr`` (Eq. 1, remote access) and ``T = 0 + a*S + b*ConPr``
(Eq. 2, placement/stage-in), reports the F-statistic of the no-intercept
fit, and scores simulations by the relative coefficient error
``E(coef_sim) = |coef_true - coef_sim| / coef_true`` (Eq. 6).

Every function is batched over leading dims: ``X [..., n, k]`` fits one
regression per leading index in one call (the reference ``vmap``-s its
single fit), in float32 with the reference's ridge ``1e-8 * I``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["OLSFit", "ols_no_intercept", "fit_eq1", "fit_eq2", "coefficient_error"]


class OLSFit(NamedTuple):
    coef: torch.Tensor  # [..., k]
    f_statistic: torch.Tensor  # [...]
    r_squared: torch.Tensor  # [...] uncentered R^2 (no-intercept convention)
    df_model: torch.Tensor  # [] = k
    df_resid: torch.Tensor  # [...] = n_obs - k


def ols_no_intercept(
    X: torch.Tensor,  # [..., n, k]
    y: torch.Tensor,  # [..., n]
    weights: Optional[torch.Tensor] = None,  # [..., n] 0/1 validity mask
) -> OLSFit:
    """Closed-form no-intercept OLS with an optional observation mask, one
    fit per leading index. Masked rows are zeroed out of the normal
    equations, matching dropping them; the degrees of freedom use the
    effective observation count."""
    f32 = torch.float32
    X = X.to(f32)
    y = y.to(f32)
    k = X.shape[-1]
    w = torch.ones_like(y) if weights is None else weights.to(f32)
    Xw = X * w[..., None]
    yw = y * w
    Xt = Xw.transpose(-1, -2)
    xtx = Xt @ Xw
    xty = (Xt @ yw[..., None])[..., 0]
    # ridge epsilon for numerical safety on near-collinear masks; a matrix
    # that is still singular in float32 gives non-finite coefficients, as
    # jnp.linalg.solve does, instead of raising
    eye = torch.eye(k, dtype=f32, device=X.device)
    coef = torch.linalg.solve_ex(xtx + 1e-8 * eye, xty).result
    resid = yw - (Xw @ coef[..., None])[..., 0]
    n_eff = w.sum(-1)
    ss_res = (resid**2).sum(-1)
    ss_tot = (yw**2).sum(-1)  # uncentered: no-intercept convention (as in R)
    ss_reg = ss_tot - ss_res
    df_model = torch.tensor(float(k), dtype=f32, device=X.device)
    df_resid = torch.clamp(n_eff - k, min=1.0)
    f_stat = (ss_reg / df_model) / torch.clamp(ss_res / df_resid, min=1e-30)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-30)
    return OLSFit(coef=coef, f_statistic=f_stat, r_squared=r2,
                  df_model=df_model, df_resid=df_resid)


def fit_eq1(
    transfer_time: torch.Tensor,
    size_mb: torch.Tensor,
    conth_mb: torch.Tensor,
    conpr_mb: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> OLSFit:
    """Paper Eq. 1: T ~ 0 + a*S + b*ConTh + c*ConPr (remote data access),
    one fit per leading index of the ``[..., n]`` observations."""
    X = torch.stack([size_mb, conth_mb, conpr_mb], dim=-1)
    return ols_no_intercept(X, transfer_time, valid)


def fit_eq2(
    transfer_time: torch.Tensor,
    size_mb: torch.Tensor,
    conpr_mb: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> OLSFit:
    """Paper Eq. 2: T ~ 0 + a*S + b*ConPr (data-placement / stage-in)."""
    X = torch.stack([size_mb, conpr_mb], dim=-1)
    return ols_no_intercept(X, transfer_time, valid)


def coefficient_error(coef_true: torch.Tensor, coef_sim: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 6: elementwise relative coefficient error."""
    return (coef_true - coef_sim).abs() / coef_true.abs()
