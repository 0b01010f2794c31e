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

The LLM substrate's weights and caches cross the same way: the reference
stacks each pattern position's parameters ``[n_units, ...]`` (``units/b{i}``)
and keeps leftover layers under ``tail/t{i}``; the port unrolls them into
layer ``u * pattern_len + i`` (the tail after). Its cache carries ``pos`` as
a Python int and one dict per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

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
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = [
    "from_reference",
    "classifier_from_reference",
    "classifier_to_reference",
    "model_params_from_reference",
    "cache_from_reference",
    "cache_to_reference",
]


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


def _leaves(
    tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unstack(
    stack: Mapping[str, Any], cfg: ModelConfig
) -> Iterator[Tuple[int, Tuple[str, ...], Any]]:
    """``(layer, path inside the layer, array)`` of a reference stack
    (``units`` stacked ``[n_units, ...]``, then ``tail``)."""
    P = cfg.pattern_len
    for path, arr in _leaves(stack.get("units") or {}):
        i = int(path[0][1:])  # "b{i}"
        for u in range(cfg.n_units):
            yield u * P + i, path[1:], np.asarray(arr)[u]
    for path, arr in _leaves(stack.get("tail") or {}):
        yield cfg.n_units * P + int(path[0][1:]), path[1:], np.asarray(arr)  # "t{i}"


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: through float32, exactly
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a)).to(dev)


def model_params_from_reference(
    params: Mapping[str, Any], cfg: ModelConfig, device: DeviceLike = None
) -> Transformer:
    """The port's model on ``device`` holding the reference's parameter
    pytree (``init_params`` of the reference's ``repro.models.model``, any
    arrays ``numpy.asarray`` reads), unit ``u``, block ``b{i}`` as layer
    ``u * pattern_len + i``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    state = {}
    for path, arr in _leaves(params):
        if path[0] != "decoder":
            state[".".join(path)] = _tensor(arr, dev)
    for layer, path, arr in _unstack(params["decoder"], cfg):
        state[".".join(("layers", str(layer)) + path)] = _tensor(arr, dev)
    model.load_state_dict(state, strict=True)
    return model


def cache_from_reference(cache: Mapping[str, Any], cfg: ModelConfig,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The port's cache (``{"pos": int, "layers": [...]}``) from the
    reference's (``pos`` scalar, ``units`` stacked, ``tail``)."""
    dev = resolve_device(device)
    layers = [dict() for _ in range(cfg.n_layers)]
    for layer, path, arr in _unstack(cache, cfg):
        layers[layer].setdefault(path[0], {})[path[1]] = _tensor(arr, dev)
    return {"pos": int(np.asarray(cache["pos"])), "layers": layers}


def cache_to_reference(cache: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's cache in the reference's layout, as numpy arrays (bf16
    entries as float32): ``pos``, ``units/b{i}/...`` stacked ``[n_units,
    ...]``, ``tail/t{i}/...``."""
    P, U = cfg.pattern_len, cfg.n_units
    arr = lambda t: t.detach().to(torch.float32).cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()
    nested = lambda c: {k: {n: arr(t) for n, t in v.items()} for k, v in c.items()}
    per_layer = [nested(c) for c in cache["layers"]]
    units = {}
    for i in range(P if U else 0):
        members = [per_layer[u * P + i] for u in range(U)]
        units[f"b{i}"] = {k: {n: np.stack([m[k][n] for m in members]) for n in members[0][k]}
                          for k in members[0]}
    out = {"pos": np.asarray(cache["pos"], dtype=np.int32), "units": units}
    if U * P < len(per_layer):
        out["tail"] = {f"t{i}": c for i, c in enumerate(per_layer[U * P:])}
    return out
