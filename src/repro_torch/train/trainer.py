"""Fault-tolerant training loop of the LLM substrate.

The port of the reference package's ``repro.train.trainer``:

- checkpoint/restart: periodic async checkpoints
  (:class:`~repro_torch.checkpoint.CheckpointStore`); on start, the latest
  committed step is restored;
- deterministic data resume: the token stream is a pure function of the
  step index, so a restart replays the exact order with no state files;
- straggler detection: a per-step wall-time EMA; steps slower than
  ``straggler_factor x`` the EMA are logged and counted (the reference's
  ``straggler_timeout_s`` is left out: nothing reads it);
- optional bf16 gradient compression with error feedback.

It runs on ``cuda`` unless the constructor is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.engine import DeviceLike, resolve_device
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig, warmup_cosine

log = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainerConfig", "Trainer", "StragglerMonitor", "adamw_config"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 200
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    clip_norm: float = 1.0
    weight_decay: float = 0.01
    grad_accum: int = 1
    compress_grads: bool = False
    straggler_factor: float = 2.5
    seed: int = 0


def adamw_config(tcfg: TrainerConfig) -> AdamWConfig:
    """The trainer's optimizer: AdamW with a warmup-cosine schedule to
    ``total_steps``, global-norm clipping and weight decay."""
    return AdamWConfig(
        lr=warmup_cosine(tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps),
        clip_norm=tcfg.clip_norm,
        weight_decay=tcfg.weight_decay,
    )


class StragglerMonitor:
    """EMA-based step-time anomaly detector."""

    def __init__(self, factor: float = 2.5, alpha: float = 0.1) -> None:
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.events = 0
        self.history: list = []

    def observe(self, dt: float) -> bool:
        """Returns True when the step is a straggler."""
        self.history.append(dt)
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.factor * self.ema
        if is_straggler:
            self.events += 1
            log.warning("straggler step: %.3fs vs EMA %.3fs", dt, self.ema)
        # stragglers do not poison the EMA
        if not is_straggler:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        *,
        seq_len: int = 512,
        global_batch: int = 8,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = adamw_config(tcfg)
        self.stream_cfg = TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=tcfg.seed,
        )
        self.store = CheckpointStore(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.monitor = StragglerMonitor(tcfg.straggler_factor)
        self._step_fn = M.make_train_step(
            cfg, self.opt_cfg, compress=tcfg.compress_grads, grad_accum=tcfg.grad_accum,
        )

    # ------------------------------------------------------------------
    def init_or_restore(self) -> Dict[str, Any]:
        params = M.init_params(self.tcfg.seed, self.cfg, device=self.device)
        state = M.init_train_state(params, self.opt_cfg)
        if self.store.latest_step() is not None:
            state, step = self.store.restore(state)
            log.info("restored checkpoint at step %d", step)
        return state

    def run(self, *, steps: Optional[int] = None) -> Dict[str, Any]:
        state = self.init_or_restore()
        start = int(state["step"])
        total = steps if steps is not None else self.tcfg.total_steps
        stream = TokenStream(self.stream_cfg, start_index=start)
        history = []
        for step in range(start, total):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(stream).items()}
            t0 = time.time()
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            self.monitor.observe(dt)
            history.append(loss)
            if (step + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f gnorm %.3f (%.0f ms)",
                         step + 1, loss, float(metrics["grad_norm"]), dt * 1e3)
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.store.save(step + 1, state, blocking=False)
        self.store.wait()
        if total > start and (total % self.tcfg.checkpoint_every) != 0:
            self.store.save(total, state, blocking=True)
        return {
            "state": state,
            "losses": history,
            "straggler_events": self.monitor.events,
            "final_step": total,
        }
