"""The harness finds every cell's files by name, and ``BENCHMARK.json`` keeps
to the shape the harness reads; ``run.py`` refuses to run without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    cfg = harness.load_config(cell["config"])
    mix = harness.load_mix(cell["traffic"])
    assert set(mix) == {"attention"} and mix["attention"] in ("sinkhorn", "softmax")
    ref = harness.reference_module(cfg)
    for fn in ("forward", "param_names", "drop_rates", "train_flops_per_image"):
        assert callable(getattr(ref, fn))
    limits = harness.load_limits(cell["name"])
    assert limits is not None and set(limits) >= set(harness.CHECK_NAMES)
    for kind in ("end_to_end", "per_layer"):
        assert harness.cell_metrics(BENCH, cell["name"], kind)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric["name"]).read)
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= {c["name"] for c in BENCH["workloads"]}


def test_metric_and_config_fields():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.find_workload(BENCH, "no_such.cell")


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", str(2**31 + 7),
                           "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_run_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
