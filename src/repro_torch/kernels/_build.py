"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds); ``csrc/*.cuh`` are headers the sources share. The
library's file name carries a hash of its source, the headers and the
flags, so an edited source or header builds anew and an unchanged one is
reused.
Libraries go to ``build/repro_torch/`` at the root of the checkout.

Run ``python -m repro_torch.kernels._build`` to build every source, all
``nvcc`` processes started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` diagnostics of the builds made by this process (``-Xptxas -v``
#: register and shared-memory counts), by source name.
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of every CUDA source under ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built with the CUDA toolkit's "
        "compiler on a machine with an NVIDIA GPU"
    )


def _lib_path(name: str) -> Path:
    # the source, the headers beside it (any source may include them) and
    # the flags: a change to any of them builds anew
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = ()) -> Dict[str, float]:
    """Compile the named sources (default: all) whose library is missing,
    every ``nvcc`` started at once. Returns wall seconds per source built."""
    names = list(names) or sources()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, tmp, proc))
    seconds: Dict[str, float] = {}
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


if __name__ == "__main__":
    for src, sec in build().items():
        print(f"built {src}.cu in {sec:.1f} s")
        print(build_logs[src])
