"""repro_torch: the GDAPS scenario-bank simulator in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the reference JAX package ``repro``; it imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
from repro_torch.core.engine import (
    SimParams,
    SimResult,
    SimSpec,
    make_bank_params,
    simulate_bank,
)
from repro_torch.core.fleet import Fleet

__version__ = "0.1.0"

__all__ = [
    "Fleet",
    "SimSpec",
    "SimParams",
    "SimResult",
    "simulate_bank",
    "make_bank_params",
]
