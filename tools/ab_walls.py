"""Time the simulator's main paths of this checkout beside another
checkout's, on one card, in turns: other, this, this, other.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    mkdir -p build/parent && git archive <commit> src | tar -x -C build/parent
    python3 tools/ab_walls.py --other build/parent [--groups fleet long_tail campaign section5 xlstm]

Each turn is a process of its own that imports one checkout's
``repro_torch`` (both packages have that name), builds its kernels into
that checkout's ``build/``, and times, by group (``--groups``, default
``fleet``):

- ``fleet``: ``Fleet.from_scenarios(n=1024).run(replicas=64)``;
- ``long_tail``: the long-tail fleet, ``Fleet.from_scenarios(n=256,
  scale=3.0, n_buckets=8).run(replicas=64)``, whose widest buckets run the
  wide kernels (its warm-up runs 4 replicas);
- ``campaign``: ``simulate_batch`` of the Section-5 campaign
  (``wlcg_production_workload(seed=0)``, max_ticks 30,000) at B = 2,048;

each in tick and leap mode with the default load and a stochastic one
(``bg_mu=2, bg_sigma=1`` for the fleet, the Section-5 launcher's ground
truth for the campaign): one warm-up run, then ``--reps`` timed runs, each
ending in ``torch.cuda.synchronize()``, with the grid-tick launches of the
last; and

- ``section5``: ``repro_torch.launch.calibrate``'s ``main`` at its
  defaults once, the seconds of each stage between
  ``torch.cuda.synchronize()`` calls;

- ``xlstm``: xlstm-350m at full width in bf16 (weights from seed 0): a
  prefill of 8 x 2,048 tokens and 64 greedy decode steps, one warm-up
  serve, then ``--reps`` timed ones (each part ending in
  ``torch.cuda.synchronize()``), with the mLSTM kernels' launches of the
  last prefill.

One JSON line per turn, a summary line (every wall of each side, and their
medians), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("tick", "default"), ("tick", "stochastic"), ("leap", "default"), ("leap", "stochastic"))
GROUPS = ("fleet", "long_tail", "campaign", "section5", "xlstm")
THETA_SECTION5 = (0.02, 36.9, 14.4)  # the Section-5 launcher's ground truth


def child(root: str, group: str, n: int, replicas: int, reps: int) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import contextlib
    import io
    import time

    import torch
    from repro_torch.kernels import grid_tick

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if group == "section5":
        from repro_torch.launch import calibrate

        @contextlib.contextmanager
        def stage(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            out[name] = dict(wall_s=[time.perf_counter() - t0])

        path = os.path.join(root, "build", "reports", "ab_section5.json")
        with contextlib.redirect_stdout(io.StringIO()):
            calibrate.main(["--device", "cuda", "--out", path], stage=stage)
        print(json.dumps(out), flush=True)
        return
    if group == "xlstm":
        from repro_torch import configs
        from repro_torch.kernels import mlstm_chunk
        from repro_torch.models import model as llm

        cfg = configs.get_config("xlstm-350m")
        B, S, N = 8, 2048, 64
        net = llm.init_params(0, cfg, device="cuda")
        prefill, step = llm.make_prefill_step(cfg), llm.make_serve_step(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(0)).to("cuda")

        def serve():
            cache = llm.init_cache(cfg, B, S + N, device="cuda")
            torch.cuda.synchronize()
            mlstm_chunk.reset_launches()
            t0 = time.perf_counter()
            logits, cache = prefill(net, cache, {"tokens": tokens})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = dict(mlstm_chunk.LAUNCHES)
            for _ in range(N):
                logits, cache = step(net, cache, logits.argmax(-1))
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1, launches

        serve()  # warm-up
        rows = [serve() for _ in range(reps)]
        out["prefill"] = dict(wall_s=[r[0] for r in rows], launches=rows[-1][2])
        out["decode_64_steps"] = dict(wall_s=[r[1] for r in rows])
        print(json.dumps(out), flush=True)
        return
    if group == "fleet":
        from repro_torch import Fleet

        fleet = Fleet.from_scenarios(n=n, seed=0, device="cuda")
        stochastic = fleet.params(bg_mu=2.0, bg_sigma=1.0)
        params = {"default": fleet.params(), "stochastic": stochastic}
        run = lambda p, leap, short=False: fleet.run(p, replicas=replicas, leap=leap)
    elif group == "long_tail":
        from repro_torch import Fleet

        fleet = Fleet.from_scenarios(n=256, seed=0, scale=3.0, n_buckets=8, device="cuda")
        params = {"default": fleet.params(), "stochastic": fleet.params(bg_mu=2.0, bg_sigma=1.0)}
        run = lambda p, leap, short=False: fleet.run(p, replicas=4 if short else replicas,
                                                     leap=leap)
    else:
        from repro_torch.core import calibration, engine, prng, workload

        table = workload.compile_campaign(*workload.wlcg_production_workload(seed=0))
        spec = engine.SimSpec.from_table(table, max_ticks=30_000, device="cuda")
        theta = torch.tensor(THETA_SECTION5, device="cuda")
        params = {"default": engine.make_params(table, device="cuda"),
                  "stochastic": calibration.make_theta_mapper(table, device="cuda")(theta)}
        keys = prng.split(prng.PRNGKey(0, "cuda"), 2048)
        run = lambda p, leap, short=False: engine.simulate_batch(
            spec._replace(max_ticks=64) if short else spec, p, keys, leap=leap)
    for mode, label in RUNS:
        leap = mode == "leap"
        run(params[label], leap, short=True)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            grid_tick.reset_launches()
            t0 = time.perf_counter()
            run(params[label], leap)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{mode}_{label}"] = dict(wall_s=walls, launches=dict(grid_tick.LAUNCHES))
    print(json.dumps(out), flush=True)


def turn(root: str, group: str, n: int, replicas: int, reps: int) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", root, "--group", group,
         "--n", str(n), "--replicas", str(replicas), "--reps", str(reps)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout (holding its src/)")
    ap.add_argument("--groups", nargs="+", default=["fleet"], choices=GROUPS)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--group", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=1024, help="scenarios")
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3, help="timed runs of each mode in a turn")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.group, args.n, args.replicas, args.reps)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_walls: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    for group in args.groups:
        turns = []
        for who, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            res = turn(root, group, args.n, args.replicas, args.reps)
            print(json.dumps({"group": group, "turn": who, **res}), flush=True)
            turns.append((who, res))
        summary = {}
        for run in turns[0][1]:
            summary[run] = {}
            for who in ("other", "this"):
                walls = sorted(x for w, r in turns if w == who for x in r[run]["wall_s"])
                summary[run][who] = dict(walls=walls, median=walls[len(walls) // 2])
        print(json.dumps({"group": group, "walls_s": summary}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
