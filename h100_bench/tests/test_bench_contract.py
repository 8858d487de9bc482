"""BENCHMARK.json and the files it names: the allowed characters and
sizes, every cell resolving its configuration, traffic mix, driver,
metric readers and limits by name, and the configuration files and
traffic templates against the program's own."""

import dataclasses
import json
import re

import pytest

from h100_bench.harness import BENCH, ROOT, resolve
from h100_bench.tests.tiny import _groups

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["h100_bench"]
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in SPEC["command"])


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).exists()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in CELLS:
        spec = resolve(cell)
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in reported and e2e[m["moves"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = resolve(cell)
    assert (BENCH / "drivers" / f"{spec['mix']['driver']}.py").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"denoise loop + UNet", "pipeline", "fused ops", "whole step", "device"}


def test_rooflines_and_mfu_in_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_configuration_files_are_the_programs():
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.pipeline.audioldm_v1 import v1_unet_config

    pc = PipelineConfig()
    a2l = json.loads((ROOT / "h100_bench/configs/audioldm2-large-apadapter.json").read_text())
    for group, values in _groups(pc).items():
        assert a2l[group] == values, group
    v1 = json.loads((ROOT / "h100_bench/configs/audioldm-s-full-v2.json").read_text())
    assert v1["unet"] == _groups(pc.replace(unet=v1_unet_config(pc)))["unet"]
    for group in ("clap", "vae", "vocoder", "scheduler"):
        assert v1[group] == a2l[group]
    assert dataclasses.replace(pc.unet).use_int8 is False


def test_traffic_templates_are_the_references():
    from ap_adapter_torch.configs import get_task_config

    for name in ("edit-b1", "edit-b8"):
        mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        for task, tpl in mix["templates"].items():
            ref = get_task_config(task)
            assert (tpl["ap_scale"], tpl["time_pool"], tpl["freq_pool"], tpl["guidance"]) == \
                (ref.ap_scale, ref.time_pooling, ref.freq_pooling, ref.guidance_scale)
            assert tpl["positive"] == list(ref.positive_text_prompts)
            assert tpl["negative"] == ref.negative_text_prompts[0]
