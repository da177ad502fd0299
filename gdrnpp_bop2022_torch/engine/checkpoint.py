"""Checkpoints of the train state with ``torch.save``.

Port of ``gdrnpp_bop2022_tpu/engine/checkpoint.py`` (reference fvcore
MyCheckpointer + PeriodicCheckpointer, engine.py:219-249), with its method
names: ``save``, ``latest_step``, ``restore_latest`` and ``max_to_keep``.
A checkpoint ``ckpt_<step>.pth`` holds the model's state dict, the EMA
weights, the optimizer's state, the step, the torch generators' states and
the trainer's own generators (``TrainState.generators``); only the newest
``max_to_keep`` stay on disk. Frame pools are not saved: a resumed run
refills them.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pth$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pth")

    def save(self, state, step: int) -> str:
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "ema": state.ema_state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "torch_rng": torch.get_rng_state(),
            "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None,
            "generators": {k: g.get_state() for k, g in state.generators.items()},
        }
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)       # a checkpoint on disk is always whole
        for old in self._steps()[:-self.max_to_keep]:
            os.unlink(self.path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, state):
        """Load the newest checkpoint into ``state`` in place (on the
        devices of its tensors) and return it; None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self.path(step), map_location="cpu", weights_only=False)
        state.model.load_state_dict(payload["model"], strict=True)
        ema = payload["ema"]
        with torch.no_grad():
            for name, e in zip(state.param_names(), state.ema):
                e.copy_(ema[name])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        torch.set_rng_state(payload["torch_rng"])
        if payload.get("cuda_rng") is not None and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(payload["cuda_rng"])
        for k, g_state in payload.get("generators", {}).items():
            if k in state.generators:
                state.generators[k].set_state(g_state)
        return state
