"""Calibration launcher: the paper's Section-5 pipeline at configurable
scale, on one campaign (``wlcg_production_workload(seed=0)``, compiled at
``max_ticks=30_000``): ``x_true`` from a synthetic ground truth, then
presimulation, the AALR classifier, MCMC and validation, on ``--device``
(default ``cuda``).

    python -m repro_torch.launch.calibrate --presim 8192 \\
        --epochs 120 --mcmc 8000 --validate 64 --replicates 4

On the CPU, at a small scale:

    python -m repro_torch.launch.calibrate --device cpu --presim 256 \\
        --epochs 4 --batch-size 256 --mcmc 1000 --burn-in 200 --chains 2 \\
        --validate 4 --replicates 1 --out /tmp/c.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, ContextManager, Optional, Sequence

import numpy as np
import torch


def main(
    argv: Optional[Sequence[str]] = None,
    stage: Optional[Callable[[str], ContextManager]] = None,
) -> dict:
    """Run the launcher with ``argv`` (default: the command line) and return
    its report. ``stage(name)``, if given, is entered as a context manager
    around each stage: ``"x_true"``, ``"presimulate"``, ``"train"``,
    ``"mcmc"`` and ``"validate"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--presim", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--replicates", type=int, default=4)
    ap.add_argument("--mcmc", type=int, default=8000)
    ap.add_argument("--burn-in", type=int, default=1500)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--validate", type=int, default=64)
    ap.add_argument("--theta-true", type=float, nargs=3,
                    default=[0.02, 36.9, 14.4],
                    help="synthetic ground truth used to generate x_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    ap.add_argument("--out", default="reports/calibration.json")
    args = ap.parse_args(argv)
    stage = stage or (lambda name: contextlib.nullcontext())

    from repro_torch.core import prng
    from repro_torch.core.calibration import (
        CalibrationConfig, calibrate, make_theta_mapper,
        simulate_coefficients, validate,
    )
    from repro_torch.core.engine import SimSpec, resolve_device
    from repro_torch.core.workload import compile_campaign, wlcg_production_workload

    dev = resolve_device(args.device)
    grid, camp = wlcg_production_workload(seed=0)
    table = compile_campaign(grid, camp)
    spec = SimSpec.from_table(table, max_ticks=30_000, device=dev)
    mapper = make_theta_mapper(table, "webdav", device=dev)
    theta_true = torch.tensor(args.theta_true, dtype=torch.float32, device=dev)
    with stage("x_true"):
        x_true = simulate_coefficients(
            spec, mapper(theta_true), prng.PRNGKey(42, dev), n_replicates=8
        )

    cfg = CalibrationConfig(
        n_presim=args.presim, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, n_replicates=args.replicates, n_chains=args.chains,
        n_mcmc=args.mcmc, burn_in=args.burn_in, step_size=0.1,
        n_validation=args.validate,
    )
    t0 = time.time()
    result = calibrate(spec, table, x_true, prng.PRNGKey(0, dev), cfg, stage=stage)
    with stage("validate"):
        val = validate(
            spec, table, result.theta_map, x_true, prng.PRNGKey(9, dev),
            n_sims=args.validate, n_replicates=args.replicates,
        )
    # Fig.-5 cornerplot artifact: per-axis histograms, 0.5 quantiles and the
    # posterior covariance (the paper reports these above each histogram)
    samples = result.posterior_samples.cpu().numpy()
    names = ["overhead", "mu", "sigma"]
    bounds = [(0.0, 0.1), (0.0, 100.0), (0.0, 100.0)]
    cornerplot = {
        "axes": names,
        "median": np.median(samples, axis=0).tolist(),
        "covariance": np.cov(samples.T).tolist(),
        "histograms": {
            n: {
                "counts": np.histogram(samples[:, i], bins=40, range=bounds[i])[0].tolist(),
                "edges": np.histogram(samples[:, i], bins=40, range=bounds[i])[1].tolist(),
            }
            for i, n in enumerate(names)
        },
    }

    np_ = lambda t: t.cpu().numpy()
    report = {
        "x_true": np_(x_true).tolist(),
        "theta_true": args.theta_true,
        "theta_star_marginal": np_(result.theta_star).tolist(),
        "theta_map": np_(result.theta_map).tolist(),
        "accept_rate": float(result.accept_rate),
        "rhat": np_(result.rhat).tolist() if result.rhat is not None else None,
        "posterior_mean": np_(result.posterior_samples.mean(0)).tolist(),
        "posterior_std": np_(result.posterior_samples.std(0, correction=0)).tolist(),
        "cornerplot": cornerplot,
        "validation_median_coef": val["median_coef"].tolist(),
        "validation_mean_abs_error": val["mean_abs_error"].tolist(),
        "validation_best_sum_error": float(val["sum_error"].min()),
        "wall_s": round(time.time() - t0, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
