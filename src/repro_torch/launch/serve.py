"""Simulation-service launcher: bring up ``repro_torch.serve.SimServer`` and
run a seeded open-loop synthetic request workload against it.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 --slots 8 \
        --rate 100 --replicas 2

Prints a JSON report: request latency percentiles, throughput, and the
server's slot-bank metrics (occupancy, idle-window fraction, realized ticks
per signature). The server runs on ``--device`` (default ``cuda``; pass
``cpu`` to run the plain PyTorch path); ``--warm-dir`` persists slot
templates across runs (``Fleet.save`` format).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def drive(server, workload):
    """Run ``workload`` (``synthetic_workload``'s ``[(arrival, request)]``)
    open loop against ``server``: each submission held to its arrival
    time, the server stepped while waiting so resident work keeps ticking,
    then drained. Returns ``(results, wall_s)``."""
    t0 = time.perf_counter()
    for arrival, req in workload:
        while time.perf_counter() - t0 < arrival:
            server.step()
        server.submit(req)
        server.step()
    results = server.drain()
    return results, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--window", type=int, default=None,
                    help="fused tick window per scheduling round")
    ap.add_argument("--leap", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scenario-family size scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--theta", type=float, nargs=3, default=None,
                    metavar=("OVERHEAD", "BG_MU", "BG_SIGMA"))
    ap.add_argument("--device", default="cuda",
                    help="device the slot banks live on (cuda or cpu)")
    ap.add_argument("--warm-dir", default=None,
                    help="slot-template warm store (Fleet.save format)")
    args = ap.parse_args()

    from repro_torch.serve import ServeConfig, SimServer, synthetic_workload

    server = SimServer(
        ServeConfig(
            slots=args.slots,
            replicas=args.replicas,
            window=args.window,
            leap=args.leap,
            warm_dir=args.warm_dir,
        ),
        device=args.device,
    )
    workload = synthetic_workload(
        args.requests,
        rate=args.rate,
        seed=args.seed,
        scale=args.scale,
        replicas=args.replicas,
        theta=None if args.theta is None else np.asarray(args.theta, np.float32),
    )

    results, wall = drive(server, workload)
    lat = np.asarray([r.latency for r in results])
    print(json.dumps({
        "requests": len(results),
        "wall_s": round(wall, 3),
        "requests_per_s": round(len(results) / max(wall, 1e-9), 1),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "metrics": server.metrics(),
    }, indent=2))


if __name__ == "__main__":
    main()
