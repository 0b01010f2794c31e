"""Time the simulator's main path of this checkout beside another
checkout's, on one card, in turns: other, this, this, other.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    mkdir -p build/parent && git archive <commit> src | tar -x -C build/parent
    python3 tools/ab_walls.py --other build/parent

Each turn is a process of its own that imports one checkout's
``repro_torch`` (both packages have that name), builds its kernels into
that checkout's ``build/``, and times ``Fleet.from_scenarios(n=1024).run(
replicas=64)`` in tick and leap mode with the bank's own load and with
``bg_mu=2, bg_sigma=1``: one warm-up run, then ``--reps`` timed runs, each
ending in ``torch.cuda.synchronize()``, with the bank kernels' launches of
the last. One JSON line per turn, a summary line (every wall of each side,
and their medians), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("tick", "default"), ("tick", "stochastic"), ("leap", "default"), ("leap", "stochastic"))


def child(root: str, n: int, replicas: int, reps: int) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import time

    import torch
    from repro_torch import Fleet
    from repro_torch.kernels import grid_tick

    torch.backends.cuda.matmul.allow_tf32 = False
    fleet = Fleet.from_scenarios(n=n, seed=0, device="cuda")
    out = {}
    for mode, label in RUNS:
        params = fleet.params(**({} if label == "default" else dict(bg_mu=2.0, bg_sigma=1.0)))
        leap = mode == "leap"
        fleet.run(params, replicas=replicas, leap=leap)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            grid_tick.reset_launches()
            t0 = time.perf_counter()
            fleet.run(params, replicas=replicas, leap=leap)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{mode}_{label}"] = dict(wall_s=walls, launches=dict(grid_tick.LAUNCHES))
    print(json.dumps(out), flush=True)


def turn(root: str, n: int, replicas: int, reps: int) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", root, "--n", str(n),
         "--replicas", str(replicas), "--reps", str(reps)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout (holding its src/)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=1024, help="scenarios")
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3, help="timed runs of each mode in a turn")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.n, args.replicas, args.reps)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_walls: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    turns = []
    for who, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = turn(root, args.n, args.replicas, args.reps)
        print(json.dumps({"turn": who, **res}), flush=True)
        turns.append((who, res))
    summary = {}
    for run in (f"{m}_{p}" for m, p in RUNS):
        summary[run] = {}
        for who in ("other", "this"):
            walls = sorted(x for w, r in turns if w == who for x in r[run]["wall_s"])
            summary[run][who] = dict(walls=walls, median=walls[len(walls) // 2])
    print(json.dumps({"walls_s": summary}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
