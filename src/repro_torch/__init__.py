"""repro_torch: the GDAPS scenario-bank simulator and its likelihood-free
calibration in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

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
from repro_torch.core.calibration import (
    AmortizedPosterior,
    CalibrationConfig,
    PriorBox,
    calibrate,
    make_theta_mapper,
    presimulate_bank,
    validate_bank,
)
from repro_torch.core.fleet import Fleet
from repro_torch.core.workload import summary_features

__version__ = "0.1.0"

__all__ = [
    "Fleet",
    "SimSpec",
    "SimParams",
    "SimResult",
    "simulate_bank",
    "make_bank_params",
    "summary_features",
    "PriorBox",
    "CalibrationConfig",
    "AmortizedPosterior",
    "calibrate",
    "make_theta_mapper",
    "presimulate_bank",
    "validate_bank",
]
