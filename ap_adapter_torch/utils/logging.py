"""Training metrics as JSONL, one object per logged step (the JAX package's
``MetricsLogger`` without its optional tensorboard and wandb backends)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: Dict[str, Any]) -> None:
        rec = dict(metrics)
        rec.setdefault("ts", time.time())
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
