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
layer ``u * pattern_len + i`` (the tail after). An encoder-decoder's
``encoder`` (one ``ATTN`` block stacked ``[encoder_layers, ...]``,
``units/b0``) unrolls into the port's ``encoder.{l}``; ``enc_final_norm``,
``frontend_proj`` and each decoder layer's ``cross`` and ``norm_cross``
keep their names. Its cache carries ``pos`` as
a Python int and one dict per layer, keyed as the reference keys a layer's
entries (``kv``, ``ssm``; ``cell`` for the mLSTM's ``C``, ``n``, ``m`` and
the sLSTM's ``h``, ``c``, ``n``, ``m``; ``cross_kv`` for the encoder
output's keys and values). Both walk the leaves by name, so
every block kind the port runs (xLSTM's ``mlstm`` and ``slstm`` too)
crosses the same way. Any tree shaped like the parameters
(gradients, AdamW moments) crosses as a dict keyed by the port's parameter
names (:func:`named_from_reference`); :func:`model_params_to_reference`
takes the port's weights back into the reference's layout. A train state
the reference's ``Trainer`` checkpointed crosses by
:func:`restore_train_state`, which the port's ``Trainer`` resumes through.
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
    "named_from_reference",
    "model_params_to_reference",
    "cache_from_reference",
    "cache_to_reference",
    "train_state_from_reference",
    "restore_train_state",
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


def _stacks(cfg: ModelConfig) -> Dict[str, Tuple[str, int, int]]:
    """The layer stacks by the port's module list: ``(the reference's
    pytree key, n_units, pattern_len)`` (the encoder is one ``ATTN`` block
    a unit)."""
    out = {"layers": ("decoder", cfg.n_units, cfg.pattern_len)}
    if cfg.is_encdec:
        out["encoder"] = ("encoder", cfg.encoder_layers, 1)
    return out


def _unstack(
    stack: Mapping[str, Any], n_units: int, P: int
) -> Iterator[Tuple[int, Tuple[str, ...], Any]]:
    """``(layer, path inside the layer, array)`` of a reference stack of
    pattern length ``P`` (``units`` stacked ``[n_units, ...]``, then
    ``tail``)."""
    for path, arr in _leaves(stack.get("units") or {}):
        i = int(path[0][1:])  # "b{i}"
        rows = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
        for u in range(n_units):
            yield u * P + i, path[1:], rows[u]
    for path, arr in _leaves(stack.get("tail") or {}):
        yield n_units * P + int(path[0][1:]), path[1:], np.asarray(arr)  # "t{i}"


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: through float32, exactly
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a)).to(dev)


def named_from_reference(
    tree: Mapping[str, Any], cfg: ModelConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """A tree shaped like the reference's parameters (the parameters, their
    gradients, AdamW's ``mu`` or ``nu``) as tensors on ``device`` keyed by the
    port's parameter names (``embed``, ``layers.{l}.attn.wq``,
    ``encoder.{l}.mlp.w_up``, ...)."""
    dev = resolve_device(device)
    stacks = _stacks(cfg)
    stacked = {key for key, _, _ in stacks.values()}
    named = {}
    for path, arr in _leaves(tree):
        if path[0] not in stacked:
            named[".".join(path)] = _tensor(arr, dev)
    for name, (key, n_units, P) in stacks.items():
        for layer, path, arr in _unstack(tree[key], n_units, P):
            named[".".join((name, str(layer)) + path)] = _tensor(arr, dev)
    return named


def model_params_from_reference(
    params: Mapping[str, Any], cfg: ModelConfig, device: DeviceLike = None
) -> Transformer:
    """The port's model on ``device`` holding the reference's parameter
    pytree (``init_params`` of the reference's ``repro.models.model``, any
    arrays ``numpy.asarray`` reads), unit ``u``, block ``b{i}`` as layer
    ``u * pattern_len + i``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    model.load_state_dict(named_from_reference(params, cfg, dev), strict=True)
    return model


def model_params_to_reference(net: Transformer, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's weights in the reference's parameter layout, as numpy
    arrays (bf16 as float32): ``decoder/units/b{i}/...`` stacked ``[n_units,
    ...]``, ``decoder/tail/t{i}/...``, an encoder-decoder's
    ``encoder/units/b0/...`` stacked ``[encoder_layers, ...]``, the rest at
    the top."""
    stacks = _stacks(cfg)
    out: Dict[str, Any] = {}
    layers: Dict[str, Dict[int, Dict[str, Any]]] = {name: {} for name in stacks}
    for name, p in net.named_parameters():
        arr = p.detach().to(torch.float32).cpu().numpy()
        path = name.split(".")
        if path[0] in stacks:
            node = layers[path[0]].setdefault(int(path[1]), {})
            path = path[2:]
        else:
            node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    def stack(members):
        if isinstance(members[0], dict):
            return {k: stack([m[k] for m in members]) for k in members[0]}
        return np.stack(members)

    for name, (key, U, P) in stacks.items():
        by_layer = layers[name]
        out[key] = {"units": {f"b{i}": stack([by_layer[u * P + i] for u in range(U)])
                              for i in range(P if U else 0)}}
        if len(by_layer) > U * P:
            out[key]["tail"] = {f"t{i}": by_layer[U * P + i]
                                for i in range(len(by_layer) - U * P)}
    return out


def cache_from_reference(cache: Mapping[str, Any], cfg: ModelConfig,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The port's cache (``{"pos": int, "layers": [...]}``) from the
    reference's (``pos`` scalar, ``units`` stacked, ``tail``)."""
    dev = resolve_device(device)
    layers = [dict() for _ in range(cfg.n_layers)]
    for layer, path, arr in _unstack(cache, cfg.n_units, cfg.pattern_len):
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


# ===========================================================================
# train state checkpoints written by the reference
# ===========================================================================
def _reference_key(name: str, cfg: ModelConfig) -> Tuple[str, int]:
    """``(the reference's pytree path of the port's parameter name, the
    length of the axis that leaf is stacked on, 0 if none)``:
    ``layers.{l}.attn.wq`` is ``decoder/units/b{l % P}/attn/wq`` (stacked
    ``[n_units, ...]``; or ``decoder/tail/t{i}/...``), ``encoder.{l}.attn.wq``
    ``encoder/units/b0/attn/wq`` (stacked ``[encoder_layers, ...]``)."""
    path = name.split(".")
    stacks = _stacks(cfg)
    if path[0] not in stacks:
        return "/".join(path), 0
    key, U, P = stacks[path[0]]
    layer, stacked = int(path[1]), U * P
    head = f"{key}/units/b{layer % P}" if layer < stacked else f"{key}/tail/t{layer - stacked}"
    return "/".join([head] + path[2:]), U if layer < stacked else 0


def _nest(leaves: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The leaves under ``prefix/`` as a nested dict, one level a path part."""
    tree: Dict[str, Any] = {}
    for key, leaf in leaves.items():
        if key.startswith(prefix + "/"):
            *parts, last = key[len(prefix) + 1:].split("/")
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = leaf
    return tree


def train_state_from_reference(leaves: Mapping[str, torch.Tensor], state: Dict[str, Any],
                               cfg: ModelConfig) -> Dict[str, Any]:
    """The port's train state from the leaves of a checkpoint that the
    reference's ``CheckpointStore`` wrote of its train state (keys its
    pytree paths: ``params/...``, ``opt/.step``, ``opt/.mu/...``,
    ``opt/.nu/...``, ``step``), held to the template ``state``
    (``init_train_state``'s): the weights through
    :func:`model_params_from_reference`, AdamW's moments through
    :func:`named_from_reference`, the steps as they are, on the template's
    device.

    Every key the template needs must be there with its shape and dtype
    (a stacked leaf ``[n_units, ...]``), and no other key may be, or a
    ``KeyError`` / ``ValueError`` names the key: nothing is filled in or cast.
    The one exception is ``grad_error/...`` (a compressing run's error
    feedback), which the template holds none of and which the reference's
    own restore leaves out too."""
    net = state["params"]
    dev = net.embed.device
    want = {"step": ((), state["step"].dtype), "opt/.step": ((), state["opt"].step.dtype)}
    for name, p in net.named_parameters():
        key, n = _reference_key(name, cfg)
        shape = ((n,) if n else ()) + tuple(p.shape)
        want["params/" + key] = (shape, p.dtype)
        for moment in ("mu", "nu"):
            want[f"opt/.{moment}/{key}"] = (shape, getattr(state["opt"], moment)[name].dtype)
    missing = sorted(set(want) - set(leaves))
    if missing:
        raise KeyError(f"reference checkpoint lacks leaf {missing[0]!r} "
                       f"({len(missing)} missing)")
    extra = sorted(k for k in set(leaves) - set(want) if not k.startswith("grad_error/"))
    if extra:
        raise KeyError(f"reference checkpoint has leaf {extra[0]!r}, which the port's "
                       f"{cfg.name} train state does not hold ({len(extra)} such)")
    for key, (shape, dtype) in want.items():
        leaf = leaves[key]
        if tuple(leaf.shape) != shape or leaf.dtype != dtype:
            raise ValueError(f"reference checkpoint leaf {key!r} is {leaf.dtype} "
                             f"{tuple(leaf.shape)}, the port's state wants {dtype} {shape}")
    opt = state["opt"]._replace(
        step=leaves["opt/.step"].to(dev),
        mu=named_from_reference(_nest(leaves, "opt/.mu"), cfg, dev),
        nu=named_from_reference(_nest(leaves, "opt/.nu"), cfg, dev),
    )
    return {"params": model_params_from_reference(_nest(leaves, "params"), cfg, dev),
            "opt": opt, "step": leaves["step"].to(dev)}


def restore_train_state(store: Any, state: Dict[str, Any],
                        cfg: ModelConfig) -> Tuple[Dict[str, Any], int]:
    """``(state, step)`` from the newest checkpoint of ``store`` (a
    :class:`~repro_torch.checkpoint.CheckpointStore`): one the port wrote
    through ``store.restore`` into the template ``state``, one the
    reference's ``CheckpointStore`` wrote (recognised by its pytree paths,
    ``params/decoder/...``) through :func:`train_state_from_reference`."""
    if not any(k.startswith("params/decoder/") for k in store.keys()):
        return store.restore(state)
    leaves, step = store.leaves()
    return train_state_from_reference(leaves, state, cfg), step
