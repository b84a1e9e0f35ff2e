"""Checkpoints and resume with torch.save (`audiolcm_tpu/train/checkpoints.py`,
which uses orbax).

Lightning's ModelCheckpoint semantics: top-k retention by a monitored
metric and mode ('min' or 'max'; by step when nothing is monitored), a
step interval, `latest_step`/`restore`, and the SIGUSR1 "save now" flag
(the reference's 'melk' handler, `main.py:793-809`). A checkpoint is
`<directory>/<step>/state.pt` (the state's `state_dict()`, or the dict
itself: module and optimizer state dicts, tensors, numbers) and
`metrics.json` beside it. Restoring into a template loads the saved state
into it (`load_state_dict`), so tensors land on the template's devices
bit for bit. Saves are synchronous, so the JAX manager's `wait` and
`close` have no counterpart.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
from typing import Any, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, monitor: Optional[str] = None,
                 mode: str = "min", save_interval_steps: int = 1):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        os.makedirs(directory, exist_ok=True)
        self.directory = os.path.abspath(directory)
        self.max_to_keep, self.monitor, self.mode = max_to_keep, monitor, mode
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d), "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def _metrics(self, step: int) -> dict:
        path = self._path(step, "metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def should_save(self, step: int, force: bool = False) -> bool:
        """orbax's rule: the first checkpoint always; later ones on the
        interval (any step when forced), never a step already saved or
        older than the latest."""
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and (force or step % self.save_interval_steps == 0)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        """Write the checkpoint of `step` if `should_save(step, force)`;
        then keep the best max_to_keep (by the monitored metric; checkpoints
        without it are kept), or the newest max_to_keep when nothing is
        monitored."""
        if not self.should_save(step, force):
            return False
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        os.makedirs(self._path(step), exist_ok=True)
        tmp = self._path(step, "state.pt.tmp")
        torch.save(sd, tmp)
        with open(self._path(step, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.replace(tmp, self._path(step, "state.pt"))
        self._retain()
        return True

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.monitor is None:
            ranked = steps  # oldest first
        else:
            scored = [(self._metrics(s)[self.monitor], s) for s in steps
                      if self.monitor in self._metrics(s)]
            ranked = [s for _, s in sorted(scored, reverse=self.mode == "min")]  # worst first
        for s in ranked[:max(len(ranked) - self.max_to_keep, 0)]:
            shutil.rmtree(self._path(s))

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The state saved at `step` (the latest when None; None when there
        is none). With a template that has `load_state_dict`, the state is
        loaded into it and the template returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        sd = torch.load(self._path(step, "state.pt"), map_location="cpu", weights_only=True)
        if template is not None and hasattr(template, "load_state_dict"):
            template.load_state_dict(sd)
            return template
        return sd


class PreemptionSaver:
    """SIGUSR1 -> a checkpoint-now flag that the train loop polls between
    steps (the reference's 'melk' handler)."""

    def __init__(self):
        self._flag = False
        try:
            signal.signal(signal.SIGUSR1, self._handler)
        except ValueError:
            pass  # not the main thread (tests)

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_save(self) -> bool:
        return self._flag

    def clear(self) -> None:
        self._flag = False
