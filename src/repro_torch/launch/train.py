"""Training launcher: :class:`~repro_torch.train.trainer.Trainer` on one
architecture, on ``--device`` (default ``cuda``), printing a JSON summary.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \\
        --batch 8 --seq 2048

On the CPU, at the reduced same-family config:

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
        --device cpu --steps 4 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the launcher with ``argv`` (default: the command line), print its
    summary and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=os.path.join(args.checkpoint_dir, cfg.name),
        peak_lr=args.lr,
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
    )
    trainer = Trainer(cfg, tcfg, seq_len=args.seq, global_batch=args.batch, device=args.device)
    out = trainer.run()
    summary = {
        "arch": cfg.name,
        "final_step": out["final_step"],
        "first_loss": out["losses"][0] if out["losses"] else None,
        "final_loss": out["losses"][-1] if out["losses"] else None,
        "straggler_events": out["straggler_events"],
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
