"""Tiny specs for CPU tests: the port's tiny configuration as a
configuration file, and the traffic mixes at two denoise steps and 0.2 s
clips (the tiny AudioMAE grid pools by 2 at most)."""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def _groups(pc) -> dict:
    def plain(v):
        if isinstance(v, tuple):
            return [plain(x) for x in v]
        return v

    return {f.name: {k: plain(v) for k, v in dataclasses.asdict(getattr(pc, f.name)).items()}
            for f in dataclasses.fields(pc) if dataclasses.is_dataclass(getattr(pc, f.name))}


def tiny_config(pipeline: str) -> dict:
    from ap_adapter_torch.configs import tiny_pipeline_config
    from ap_adapter_torch.pipeline.audioldm_v1 import v1_unet_config

    pc = tiny_pipeline_config()
    groups = _groups(pc)
    if pipeline == "audioldm_v1":
        groups["unet"] = _groups(pc.replace(unet=v1_unet_config(pc)))["unet"]
    return {"name": "tiny", "pipeline": pipeline, "dtype": "float32", "hoist_step_invariants": True, **groups}


def tiny_mix(name: str, batch: int = 0) -> dict:
    mix = copy.deepcopy(json.loads((BENCH / "traffic" / f"{name}.json").read_text()))
    mix.update(steps=2, audio_seconds=0.2, check_calls=2)
    if batch:
        mix["batch"] = batch
    for tpl in mix.get("templates", {}).values():
        tpl["time_pool"], tpl["freq_pool"] = 2, 2
    return mix


def tiny_spec(cell: str) -> dict:
    """A ``harness.resolve``-shaped spec of ``cell`` at the tiny sizes."""

    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    mix = tiny_mix(entry["traffic"])
    pipeline = "audioldm_v1" if mix["driver"] == "v1_generate" else "audioldm2"
    return {"cell": entry, "config": tiny_config(pipeline), "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]],
            "per_layer": [m for m in bench["per_layer"] if "workloads" not in m or cell in m["workloads"]],
            "limits": json.loads((BENCH / "limits" / f"{cell}.json").read_text())}
