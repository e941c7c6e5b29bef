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
    assert set(metric.get("workloads", [])) <= {c["name"] for c in BENCH["workloads"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_a_cell_list_names_some_cells_not_all(metric):
    # a metric that every cell reports has no list, so that a cell added
    # later reports it too
    if "workloads" in metric:
        cells = {c["name"] for c in BENCH["workloads"]}
        assert metric["workloads"] and set(metric["workloads"]) < cells
        assert len(set(metric["workloads"])) == len(metric["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_a_cell_reports_what_its_per_layer_metrics_move(cell):
    # every cell reports setup_s and another end-to-end metric; each of its
    # per-layer metrics moves one that it reports; a per-layer metric with no
    # list is every cell's that reports what it moves, and no other's
    ends = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in ends and len(ends) >= 2
    layers = harness.cell_metrics(BENCH, cell["name"], "per_layer")
    assert layers and all(m["moves"] in ends for m in layers)
    for m in BENCH["per_layer"]:
        if "workloads" not in m:
            assert (m in layers) == (m["moves"] in ends)
    # beside a kernel's roofline, the whole step's share of the peak moving
    # the same end-to-end metric
    for m in layers:
        if m["name"].endswith("_roofline_pct") or m["name"].endswith("_roofline"):
            assert any("mfu" in k["name"] and k["moves"] == m["moves"] for k in layers)


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


@pytest.mark.parametrize("planted,refused", [
    ("jax", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("noise_robust_vit_tpu.models", True), ("noise_robust_vit_tpu_torch", False),
    ("jaxtyping", False)])
def test_run_refuses_a_result_once_jax_is_loaded(monkeypatch, capsys, planted, refused):
    import types

    import torch

    from benchmark import run

    def fake_run_cell(*args, **kwargs):
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
                "checks": {"loss_gap": {"value": 0.0, "limit": 1.0}}}

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(harness, "run_cell", fake_run_cell)
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", str(2**31 + 9),
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if refused:
        assert rc != 0 and out == ""
        assert planted.split(".")[0] in err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]
