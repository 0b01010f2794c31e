"""Carry the reference package's inputs across to the port.

The simulator's "weights" are its compiled campaigns, its parameters and
its keys. :func:`from_reference` takes them as the reference package holds
them (a bank with numpy arrays or a stacked ``SimSpec`` with ``[N, R, 2]``
keys; or one campaign's unstacked ``SimSpec`` with ``[B, 2]`` keys; a
``SimParams`` of arrays in either case), duck-typed and read through
``numpy.asarray``, and returns the port's
:class:`~repro_torch.core.engine.SimSpec` (index tables filled),
:class:`~repro_torch.core.engine.SimParams` and int64 keys on ``device``,
so both packages run the same inputs.

The classifier's weights cross both ways:
:func:`classifier_from_reference` copies the reference's parameter pytree
(``w0..wD`` / ``b0..bD`` arrays) into the port's dict of float32 tensors,
and :func:`classifier_to_reference` returns the port's as numpy arrays, which
the reference's functions take as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (
    INDEX_TABLE_FIELDS,
    DeviceLike,
    SimParams,
    SimSpec,
    resolve_device,
    with_index_tables,
)

__all__ = ["from_reference", "classifier_from_reference", "classifier_to_reference"]


def from_reference(
    bank: Any, params: Any, keys: Any, device: DeviceLike = None
) -> Tuple[SimSpec, SimParams, torch.Tensor]:
    """``(SimSpec, SimParams, keys)`` on ``device`` from a reference bank
    (or stacked reference ``SimSpec``) with ``[N, R, 2]`` keys, or from one
    campaign's unstacked reference ``SimSpec`` with ``[B, 2]`` keys, and
    reference ``SimParams``."""
    dev = resolve_device(device)
    t = lambda a: None if a is None else torch.as_tensor(np.array(a)).to(dev)
    fields = [f for f in SimSpec._fields if f not in INDEX_TABLE_FIELDS]
    spec = with_index_tables(SimSpec(**{f: t(getattr(bank, f)) for f in fields}))
    sim_params = SimParams(*(t(getattr(params, f, None)) for f in SimParams._fields))
    return spec, sim_params, t(np.asarray(keys).astype(np.int64))


def classifier_from_reference(
    params: Mapping[str, Any], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The reference's classifier parameters (any arrays ``numpy.asarray``
    reads) as the port's dict of float32 tensors on ``device``, same keys."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev)
        for k, v in params.items()
    }


def classifier_to_reference(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's classifier parameters as float32 numpy arrays, same keys."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}
