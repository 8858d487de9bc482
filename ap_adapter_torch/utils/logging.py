"""Training metrics: a JSONL file, one object per logged step, always; and
the optional tensorboard and wandb backends.

Counterpart of ``ap_adapter_tpu/utils/logging.py``. The backends are soft:
each is chosen at construction and skipped when its package does not import
(neither is a dependency of the port). tensorboard goes through
``torch.utils.tensorboard.SummaryWriter``, with the scalars at ``step``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: str, tensorboard_dir: Optional[str] = None, wandb_project: Optional[str] = None,
                 wandb_config: Optional[Dict[str, Any]] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                wandb.init(project=wandb_project, config=wandb_config or {}, resume="allow")
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any]) -> None:
        rec = dict(metrics)
        rec.setdefault("ts", time.time())
        self._f.write(json.dumps(rec) + "\n")
        scalars = {k: v for k, v in rec.items() if isinstance(v, (int, float)) and k not in ("step", "ts")}
        if self._tb is not None and "step" in rec:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, rec["step"])
        if self._wandb is not None:
            self._wandb.log(scalars, step=rec.get("step"))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass
