"""Observation datasets derived from simulation results.

The port of ``repro.core.dataset``: every launched file access is an
observation with fields (T, S, ConTh, ConPr); this module slices a
:class:`~repro_torch.core.engine.SimResult` into such datasets (any leading
dims, the fits batch over them) and partitions them by start hour for the
Fig.-3 time series.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.engine import SimResult
from repro_torch.core.regression import OLSFit, fit_eq1, fit_eq2
from repro_torch.core.workload import ProfileTag

__all__ = [
    "ObsDataset",
    "observations",
    "fit_profile",
    "hourly_coefficients",
]


class ObsDataset(NamedTuple):
    transfer_time: torch.Tensor  # [..., N]
    size_mb: torch.Tensor  # [..., N]
    conth_mb: torch.Tensor  # [..., N]
    conpr_mb: torch.Tensor  # [..., N]
    valid: torch.Tensor  # [..., N] f32 mask (done legs of the requested profile)
    start_tick: torch.Tensor  # [..., N] f32 (for time partitioning)


def observations(
    res: SimResult,
    profile: Optional[int] = None,
    *,
    start_tick: Optional[torch.Tensor] = None,
) -> ObsDataset:
    """A masked observation dataset of a simulation result.

    ``profile`` filters legs by :class:`ProfileTag`; ``None`` keeps all legs.
    Shapes stay those of the result, and the regressions read the mask as
    observation weights. Legs that never finished (``~done``) are always
    dropped: they have no defined transfer time.
    """
    valid = res.done
    if profile is not None:
        valid = valid & (res.profile == int(profile))
    if start_tick is None:
        start_tick = torch.zeros_like(res.transfer_time)
    return ObsDataset(
        transfer_time=res.transfer_time,
        size_mb=res.size_mb,
        conth_mb=res.conth_mb,
        conpr_mb=res.conpr_mb,
        valid=valid.to(torch.float32),
        start_tick=start_tick,
    )


def fit_profile(ds: ObsDataset, profile: int) -> OLSFit:
    """The paper's regression for the profile: Eq. 1 for remote access (3
    regressors), Eq. 2 for placement/stage-in."""
    if profile == ProfileTag.REMOTE:
        return fit_eq1(ds.transfer_time, ds.size_mb, ds.conth_mb, ds.conpr_mb, ds.valid)
    return fit_eq2(ds.transfer_time, ds.size_mb, ds.conpr_mb, ds.valid)


def hourly_coefficients(
    res: SimResult,
    profile: int,
    *,
    start_ticks: torch.Tensor,
    ticks_per_partition: int = 3600,
    n_partitions: int = 24,
) -> np.ndarray:
    """Fig. 3: partition observations by start hour and fit Eq. 2 per
    partition. Returns ``[n_partitions, 2]`` (a, b) with NaN rows for
    partitions with fewer than 3 usable observations."""
    base = observations(res, profile)
    out = np.full((n_partitions, 2), np.nan, np.float64)
    start = torch.as_tensor(start_ticks, device=base.valid.device)
    for h in range(n_partitions):
        in_part = (start >= h * ticks_per_partition) & (
            start < (h + 1) * ticks_per_partition
        )
        mask = base.valid * in_part.to(torch.float32)
        if float(mask.sum()) < 3:
            continue
        fit = fit_eq2(base.transfer_time, base.size_mb, base.conpr_mb, mask)
        out[h] = fit.coef.cpu().numpy().astype(np.float64)
    return out
