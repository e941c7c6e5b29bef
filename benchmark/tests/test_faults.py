"""The comparison that decides ``correct``, shown to fail. On the CPU at tiny
sizes, each cell's run (its checked steps, window and reference, with the
cell's own limits) comes out correct for the sound program and not correct
with the timed path broken underneath: a step that leaves the state
unchanged, and half of each batch left out (the loss a mean over the rest).
The control, the reference with every product's operands in fp8 in place of
the program, fails a limit on three seeds."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import half_batch
from benchmark.reference import common
from benchmark.spans import SKIP_STEPS

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def unchanged(state) -> None:
    """Fault: the step computes its loss and gradients, and updates nothing."""
    state.optimizer.step = lambda *a, **k: None


def run(workload, seed, fault=None, trace=False):
    return harness.run_cell(workload, seed, 0.2, trace, "cpu", time.perf_counter(), BENCH,
                            fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small, workload):
    r = run(workload, SEEDS[0])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # off the card there is no device op, so no device time a step
    assert set(r["metrics"]) == {m["name"] for m in harness.cell_metrics(
        BENCH, workload, "end_to_end")} - {"device_step_ms"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(small, workload, fault):
    r = run(workload, SEEDS[1], fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(small, workload):
    cell = harness.find_workload(BENCH, workload)
    cfg, mix = small[cell["config"]], harness.load_mix(cell["traffic"])
    limits = harness.load_limits(workload)
    cpu = torch.device("cpu")
    for seed in SEEDS:
        ref = harness.reference_steps(cfg, mix, seed, cpu, 3)
        control = harness.reference_steps(cfg, mix, seed, cpu, 3, common.fp8)
        ok, checks = harness.judge(harness.compare(control, ref), limits)
        assert not ok, checks


def test_traced_run_reads_the_per_layer_metrics_it_can(small):
    r = run("swin_t.robust", SEEDS[2], trace=True)
    assert r["correct"], r["checks"]
    # on the CPU there is no device op: only the readers of the stretch and
    # of its step spans find something; of those, a Swin-T cell reports the
    # ones that move its device step, and its wall rate
    assert set(r["metrics"]) == {"wall_img_s", "stretch_step_ms_p95", "forward_ms",
                                 "backward_ms"}
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


def test_traced_run_of_a_rate_cell_reads_its_host_side_metrics(small):
    r = run("simple_vit_b16.vanilla", SEEDS[2], trace=True)
    assert r["correct"], r["checks"]
    # a cell that reports train_img_s reads the host side of its step too;
    # the lead's past the first steps
    names = {"host_enqueue_ms", "mfu", "forward_ms", "backward_ms"}
    if r["attempted"] > SKIP_STEPS:
        names.add("host_lead_ms_p5")
        # on the CPU the spans' device clock is the host's: no lead
        assert r["metrics"]["host_lead_ms_p5"]["value"] == 0.0
    assert set(r["metrics"]) == names
