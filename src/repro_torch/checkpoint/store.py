"""Crash-consistent checkpoints of the port's train state, in the reference
package's on-disk layout (``repro.checkpoint.store``)::

    <dir>/step_00000042/
        manifest.json        # step, and per leaf: key, file, shape, dtype
        leaf_00000.npy ...   # one .npy per leaf (a host copy)
        _COMPLETE            # commit marker written last
    <dir>/latest             # text file naming the last committed step

- **atomicity**: a checkpoint is staged in ``step_XXXXXXXX.tmp`` and
  committed by a rename, then ``latest`` is replaced; a crash mid-save never
  names an incomplete step, and a step directory without ``_COMPLETE`` is
  ignored;
- **async save**: ``save(..., blocking=False)`` copies every leaf to the host
  on the caller's thread (so the train loop may overwrite its tensors next),
  then writes on a background thread; ``wait()`` (and the next ``save``)
  re-raises what the write raised;
- retention of the newest ``keep`` checkpoints.

A tree is nested dicts, named tuples (``AdamWState``), ``nn.Module``\\ s (their
``state_dict``) and tensors; a leaf's key is its path joined by ``/``
(``params/layers.0.attn.wq``, ``opt/mu/embed``, ``step``). numpy has no
bf16, so a bf16 leaf is stored as its ``uint16`` bits with ``bfloat16`` in the
manifest, as the reference stores ``ml_dtypes`` arrays. ``restore(template)``
puts each leaf on the template leaf's device and dtype: the single-card
counterpart of the reference's elastic restore.

A checkpoint the reference's store wrote keys its leaves by pytree path
(``params/decoder/units/b0/attn/wq``, ``opt/.mu/embed``, ``opt/.step``):
``leaves()`` reads any checkpoint by key, and
:func:`repro_torch.convert.restore_train_state` maps such a one onto the
port's train state.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointStore"]

log = logging.getLogger("repro_torch.checkpoint")

Tree = Any


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict().items():
            yield "/".join(prefix + (name,)), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, torch.Tensor):
        yield "/".join(prefix), tree
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)!r} is a {type(tree).__name__}, "
                        "not a tensor")


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Tree, *, blocking: bool = True) -> None:
        """Persist a tree of tensors as step ``step``."""
        self.wait()  # one async save in flight at a time
        # device -> host on this thread, as copies the train loop cannot touch
        host = [(k, t.detach().to("cpu", copy=True)) for k, t in _flatten(tree)]

        def _write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest: Dict[str, Any] = {"step": step, "leaves": []}
            for i, (key, t) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                arr, dtype_name = _to_storable(t)
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fname, "shape": list(t.shape), "dtype": dtype_name})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.directory, "latest.tmp"), "w") as f:
                f.write(f"step_{step:08d}")
            os.replace(os.path.join(self.directory, "latest.tmp"),
                       os.path.join(self.directory, "latest"))
            self._gc()
            log.info("checkpoint step %d committed", step)

        def _write_async():
            try:
                _write()
            except BaseException as e:  # handed to the caller by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the async save in flight, raising what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "latest")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.directory, name, "_COMPLETE")):
            log.warning("latest checkpoint %s incomplete; scanning", name)
            return self._scan_latest()
        return int(name.split("_")[1])

    def _scan_latest(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.directory)
                 if d.startswith("step_") and not d.endswith(".tmp")
                 and os.path.exists(os.path.join(self.directory, d, "_COMPLETE"))]
        return max(steps) if steps else None

    def _manifest(self, step: Optional[int]) -> Tuple[str, Dict[str, Any], int]:
        """``(checkpoint directory, manifest entries by key, step)`` of
        ``step`` (default the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(ckpt, "manifest.json")) as f:
            return ckpt, {e["key"]: e for e in json.load(f)["leaves"]}, step

    def keys(self, *, step: Optional[int] = None) -> List[str]:
        """The leaf keys of a checkpoint (default the latest)."""
        return list(self._manifest(step)[1])

    def leaves(self, *, step: Optional[int] = None) -> Tuple[Dict[str, torch.Tensor], int]:
        """``({key: leaf}, step)``: every leaf of a checkpoint (default the
        latest) as a CPU tensor in its stored dtype, whatever tree wrote it
        (the reference's ``CheckpointStore`` writes the same layout)."""
        ckpt, by_key, step = self._manifest(step)
        return {key: _from_storable(np.load(os.path.join(ckpt, e["file"])), e["dtype"])
                for key, e in by_key.items()}, step

    def restore(self, template: Tree, *, step: Optional[int] = None) -> Tuple[Tree, int]:
        """``(tree, step)``: the checkpoint (default the latest) in the
        structure of ``template``, each leaf on its template leaf's device
        and dtype. A module in the template is loaded in place and returned."""
        ckpt, by_key, step = self._manifest(step)

        def load(key: str, tmpl: torch.Tensor) -> torch.Tensor:
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _from_storable(np.load(os.path.join(ckpt, entry["file"])), entry["dtype"])
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                                 f"template {tuple(tmpl.shape)}")
            return t.to(device=tmpl.device, dtype=tmpl.dtype)

        def build(tree: Tree, prefix: Tuple[str, ...]) -> Tree:
            if isinstance(tree, nn.Module):
                with torch.no_grad():
                    for name, t in tree.state_dict().items():
                        t.copy_(load("/".join(prefix + (name,)), t))
                return tree
            if isinstance(tree, dict):
                return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
            if _is_namedtuple(tree):
                return type(tree)(*(build(getattr(tree, k), prefix + (k,)) for k in tree._fields))
            return load("/".join(prefix), tree)

        return build(template, ()), step

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
