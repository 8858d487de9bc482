"""Checkpoint IO: rotating training-state checkpoints (``torch.save``) and the
reference-format flat adapter dict (``.npz``).

Counterpart of ``ap_adapter_tpu/utils/checkpoint.py``: a training state is
``{"step", "adapter": {flat key: fp32 tensor}, "optimizer": state dict}``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def save_flat_adapter(path: str, flat: Dict[str, np.ndarray]) -> None:
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_flat_adapter(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


class TrainCheckpointer:
    """Step checkpoints ``<directory>/step_<n>.pt``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state: dict) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self) -> Optional[dict]:
        """The newest checkpoint (tensors on the CPU), or None."""

        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
