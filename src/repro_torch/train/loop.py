"""Training loop with checkpoint/restart, heartbeats and straggler flags.

Counterpart of ``repro.train.loop``: host-side orchestration around the
train step.

  * periodic atomic checkpoints (params, optimizer, data state);
  * resume from the newest checkpoint on startup (crash or preemption
    recovery), the data stream seeked to where it stood;
  * a heartbeat file per step, for an external watchdog;
  * step-time EMA straggler detection: a step slower than
    ``straggler_factor`` x the EMA is logged;
  * metrics JSONL, each record carrying the live telemetry snapshot.

The ``train/step`` span is the step timer.  On a CUDA device it is
device-true (CUDA events on the current stream), and the step ends in a
readback of its loss, where the reference blocks until it is ready.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional

from repro_torch import telemetry as T
from repro_torch.models.model_api import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: str = "checkpoints"
    metrics_path: Optional[str] = None
    heartbeat_path: Optional[str] = None
    straggler_factor: float = 3.0
    keep_last: int = 3


class TrainLoop:
    def __init__(self, *, train_step: Callable, state, data, cfg: LoopConfig):
        from repro_torch.train.checkpoint import CheckpointManager
        self.step_fn = train_step
        self.state = state
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep_last=cfg.keep_last)
        self.metrics: list = []
        self._ema_step_time = None

    @property
    def device(self):
        return tree_leaves(self.state.params)[0].value.device

    # -- fault tolerance ------------------------------------------------------
    def try_resume(self) -> int:
        """Restore the newest committed checkpoint if one exists; returns
        its step (0 without one)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state, extra = self.ckpt.restore(self.state, step=latest)
        if "data_state" in extra and hasattr(self.data, "state"):
            from repro_torch.data.pipeline import DataState
            self.data.state = DataState.from_dict(extra["data_state"])
        return latest

    def _heartbeat(self, step: int):
        if self.cfg.heartbeat_path:
            Path(self.cfg.heartbeat_path).write_text(
                json.dumps({"step": step, "time": T.walltime()}))

    def _checkpoint(self, step: int):
        extra = {}
        if hasattr(self.data, "state"):
            extra["data_state"] = self.data.state.to_dict()
        self.ckpt.save(step, self.state, extra=extra)

    # -- main -------------------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> list:
        step = self.try_resume() if start_step is None else start_step
        cfg = self.cfg
        while step < cfg.total_steps:
            # the span is the step timer: its histogram feeds the JSONL
            # snapshot and its elapsed_s the EMA
            with T.span("train/step", device=self.device) as sp:
                batch = self.data.next_batch()
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])
            dt = sp.elapsed_s
            step += 1

            ema = self._ema_step_time
            self._ema_step_time = dt if ema is None else 0.9 * ema + 0.1 * dt
            straggler = (ema is not None and
                         dt > cfg.straggler_factor * ema)

            self._heartbeat(step)
            if step % cfg.log_every == 0 or straggler or \
                    step == cfg.total_steps:
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]),
                       "step_time_s": round(dt, 4),
                       "straggler": bool(straggler),
                       "telemetry": T.snapshot()}
                self.metrics.append(rec)
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            if step % cfg.checkpoint_every == 0 or step == cfg.total_steps:
                self._checkpoint(step)
        return self.metrics
