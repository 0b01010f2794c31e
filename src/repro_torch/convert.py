"""Carry the reference package's inputs across to the port.

The simulator's "weights" are its compiled bank, its parameters and its
replica keys. :func:`from_reference` takes them as the reference package
holds them (a bank with numpy arrays, a ``SimParams`` of arrays, ``[N, R,
2]`` uint32 keys), duck-typed and read through ``numpy.asarray``, and
returns the port's :class:`~repro_torch.core.engine.SimSpec`,
:class:`~repro_torch.core.engine.SimParams` and int64 keys on ``device``,
so both packages run the same inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

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

__all__ = ["from_reference"]


def from_reference(
    bank: Any, params: Any, keys: Any, device: DeviceLike = None
) -> Tuple[SimSpec, SimParams, torch.Tensor]:
    """``(SimSpec, SimParams, keys)`` on ``device`` from a reference bank
    (or stacked reference ``SimSpec``), reference ``SimParams`` and
    ``[N, R, 2]`` keys."""
    dev = resolve_device(device)
    t = lambda a: None if a is None else torch.as_tensor(np.array(a)).to(dev)
    fields = [f for f in SimSpec._fields if f not in INDEX_TABLE_FIELDS]
    spec = with_index_tables(SimSpec(**{f: t(getattr(bank, f)) for f in fields}))
    sim_params = SimParams(*(t(getattr(params, f, None)) for f in SimParams._fields))
    return spec, sim_params, t(np.asarray(keys).astype(np.int64))
