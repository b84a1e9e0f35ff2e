"""The training loop harness (`audiolcm_tpu/train/loop.py`), in place of the
reference's pytorch-lightning Trainer (`main.py:555-845`):
  * learning-rate scaling lr = accumulate * devices * batch_size * base_lr
    (`main.py:781-788`);
  * per-epoch wall time and the card's peak allocated memory (CUDACallback,
    `main.py:532-552`);
  * checkpoints every `checkpoint_every_steps` and after every epoch (on
    the manager's interval), and on SIGUSR1 and before an exception
    propagates (at any step) (SetupCallback and 'melk',
    `main.py:318-322,793-809`);
  * metrics as JSONL lines (and TensorBoard or wandb when installed), a
    sample-logging hook and a validation hook per epoch.

The step function is the trainer module's (`train/lcm_distill.py`,
`train/teacher.py`), called as step_fn(state, batch, generator); the loop
passes the one torch.Generator it was given, which each step advances.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from audiolcm_torch.train.checkpoints import CheckpointManager, PreemptionSaver
from audiolcm_torch.train.logging import make_logger


def scale_learning_rate(base_lr: float, batch_size: int, num_devices: int,
                        accumulate: int = 1) -> float:
    """`main.py:781-788`."""
    return accumulate * num_devices * batch_size * base_lr


class MetricsLogger:
    """One JSON object per line: {"step": n, metric: value, ...}."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._fh = open(self.path, "a")

    def log(self, step: int, metrics: dict) -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def device_peak_memory_bytes() -> Optional[int]:
    """torch.cuda.max_memory_allocated of the current card; None without one."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated()


class Trainer:
    def __init__(self, step_fn: Callable, state: Any, logdir: str,
                 checkpoints: Optional[CheckpointManager] = None,
                 val_fn: Optional[Callable] = None, sample_logger: Optional[Callable] = None,
                 log_every: int = 50, sample_every: int = 5000,
                 checkpoint_every_steps: int = 10000, tensorboard: bool = True,
                 logger: str = "tensorboard"):
        """step_fn(state, batch, generator) -> (state, metrics);
        val_fn(state, epoch) -> dict; sample_logger(state, step)."""
        self.step_fn, self.state, self.logdir = step_fn, state, logdir
        self.metrics = MetricsLogger(logdir)
        self.tb = make_logger(logger, os.path.join(logdir, "tb"), enabled=tensorboard)
        self.checkpoints = checkpoints
        self.val_fn, self.sample_logger = val_fn, sample_logger
        self.log_every, self.sample_every = log_every, sample_every
        self.checkpoint_every_steps = checkpoint_every_steps
        self.preemption = PreemptionSaver()
        self.global_step = 0

    def _save(self, metrics: Optional[dict] = None, force: bool = False) -> None:
        if self.checkpoints is not None:
            self.checkpoints.save(self.global_step, self.state, metrics, force=force)

    def fit(self, loader_factory: Callable[[int], Iterable], num_epochs: int,
            generator: Optional[torch.Generator] = None) -> None:
        """loader_factory(epoch) -> the epoch's batches."""
        try:
            for epoch in range(num_epochs):
                t0 = time.time()
                last_metrics: dict = {}
                for batch in loader_factory(epoch):
                    self.state, metrics = self.step_fn(self.state, batch, generator)
                    self.global_step += 1
                    last_metrics = metrics
                    if self.global_step % self.log_every == 0:
                        self.metrics.log(self.global_step, metrics)
                        self.tb.scalars(self.global_step, metrics)
                    if self.sample_logger and self.global_step % self.sample_every == 0:
                        self.sample_logger(self.state, self.global_step)
                    if self.global_step % self.checkpoint_every_steps == 0:
                        self._save(metrics)
                    if self.preemption.should_save:
                        self._save(metrics, force=True)
                        self.preemption.clear()
                epoch_metrics = {"epoch": epoch, "epoch_time_s": time.time() - t0}
                peak = device_peak_memory_bytes()
                if peak is not None:
                    epoch_metrics["peak_memory_mb"] = peak / 2**20
                if self.val_fn is not None:
                    epoch_metrics.update(self.val_fn(self.state, epoch))
                self.metrics.log(self.global_step, epoch_metrics)
                self.tb.scalars(self.global_step, epoch_metrics)
                self._save({**last_metrics, **epoch_metrics})
        except BaseException:
            self._save(force=True)  # save 'last' before the exception propagates
            raise
        finally:
            self.tb.close()
