"""repro_torch: the GDAPS grid simulator (one campaign or a scenario bank),
its likelihood-free calibration, the access-profile optimizer and the LLM
substrate's serving path (prefill and decode of hybrid attention / SSD
models) in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the reference JAX package ``repro``; it imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
from repro_torch.core.engine import (
    SimParams,
    SimResult,
    SimSpec,
    make_bank_params,
    make_params,
    simulate,
    simulate_bank,
    simulate_batch,
)
from repro_torch.core.calibration import (
    AmortizedPosterior,
    CalibrationConfig,
    PriorBox,
    calibrate,
    make_theta_mapper,
    presimulate,
    presimulate_bank,
    simulate_coefficients,
    validate,
    validate_bank,
)
from repro_torch.core.fleet import Fleet
from repro_torch.core.workload import summary_features
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache, init_params, make_prefill_step, make_serve_step

__version__ = "0.1.0"

__all__ = [
    "Fleet",
    "SimSpec",
    "SimParams",
    "SimResult",
    "simulate",
    "simulate_batch",
    "simulate_bank",
    "make_params",
    "make_bank_params",
    "summary_features",
    "PriorBox",
    "CalibrationConfig",
    "AmortizedPosterior",
    "calibrate",
    "make_theta_mapper",
    "simulate_coefficients",
    "presimulate",
    "presimulate_bank",
    "validate",
    "validate_bank",
    "ModelConfig",
    "init_params",
    "init_cache",
    "make_prefill_step",
    "make_serve_step",
]
