"""Checkpointing (port of emx/train/checkpoints.py): step- and
time-periodic saves, and deterministic resume including the data
pipeline's cursor.

A checkpoint is one `torch.save` file per step, `ckpt_<step>.pt`, holding
the step, the model's state dict (parameters and BatchNorm statistics),
the optimizer's state dict (buffers and learning rate) and the pipeline
cursor. It is written to a temporary file and renamed into place, so a
crash mid-save never leaves a truncated checkpoint. emx's orbax layout
is not read or written. `restore` loads into a live TrainState, so a
resumed run continues bit for bit on the CPU.
"""

from __future__ import annotations

import os
import re

import torch

from emx_torch.train.engine import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int | None = 5):
        """Keep the newest `max_to_keep` checkpoints (None keeps all)."""
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.fullmatch, os.listdir(self.directory)) if m)

    def save(self, step: int, state: TrainState,
             pipeline_state: dict | None = None, wait: bool = False) -> None:
        """Write checkpoint `step`; drop the oldest beyond max_to_keep.
        Saves are synchronous, so `wait` has nothing to wait for."""
        payload = {"step": int(state.step),
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "pipeline": (None if pipeline_state is None else
                                {k: int(v) for k, v in
                                 pipeline_state.items()})}
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_state: TrainState, step: int | None = None
                ) -> tuple[TrainState, dict | None]:
        """Load checkpoint `step` (the latest by default) into
        `target_state` (Trainer.init's output) in place; returns
        (state, pipeline_state or None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(target_state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        target_state.model.load_state_dict(payload["model"])
        target_state.optimizer.load_state_dict(payload["optimizer"])
        target_state.step = payload["step"]
        return target_state, payload["pipeline"]

    def rollback(self, target_state: TrainState
                 ) -> tuple[TrainState, dict | None]:
        """Restore the most recent checkpoint (the GAN collapse-recovery
        path, reference gan-infilling-100.py:1827-1830)."""
        return self.restore(target_state)

    def close(self) -> None:
        """Nothing is left in flight: saves are synchronous."""
