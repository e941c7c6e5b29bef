"""The readers of the port's step spans (``forward_ms``, ``backward_ms``,
``host_lead_ms_p5``) on synthetic records and on a CPU stretch traced by the
port's ``StepTracer``; the spans line; the card's state off the card."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.metrics import backward_ms, forward_ms, host_lead_ms_p5

READERS = (forward_ms, backward_ms, host_lead_ms_p5)
BOUNDARIES = ("begin", "forward_end", "backward_end", "optimizer_end")


def record(step: int, phases_ms, lead_ms: float) -> dict:
    """A step whose device phases take ``phases_ms`` (forward, backward,
    optimizer), its host marks ``lead_ms`` ahead of the device at every
    boundary."""
    dev = [10.0 * step]
    for p in phases_ms:
        dev.append(dev[-1] + p)
    return {"step": step,
            "boundaries": {b: {"host_ms": d - lead_ms, "device_ms": d, "lead_ms": lead_ms}
                           for b, d in zip(BOUNDARIES, dev)},
            "phases": {p: {"host_ms": 0.1, "device_ms": ms}
                       for p, ms in zip(("forward", "backward", "optimizer"), phases_ms)}}


def test_phase_readers_take_the_median():
    recs = [record(s, (f, 2 * f, 0.5), 3.0) for s, f in enumerate([5.0, 1.0, 3.0, 4.0, 2.0])]
    ctx = SimpleNamespace(spans=recs)
    assert forward_ms.read(ctx) == 3.0
    assert backward_ms.read(ctx) == 6.0


def test_lead_reader_leaves_out_the_first_steps():
    # the first 5 steps lead by -100 ms: counted, they would be the 5th percentile
    recs = [record(s, (1.0, 1.0, 1.0), -100.0 if s < spans.SKIP_STEPS else float(s))
            for s in range(spans.SKIP_STEPS + 21)]
    leads = [float(s) for s in range(spans.SKIP_STEPS, spans.SKIP_STEPS + 21)
             for _ in BOUNDARIES]
    assert len(spans.leads_ms(recs)) == 4 * 21
    got = host_lead_ms_p5.read(SimpleNamespace(spans=recs))
    # 84 leads, four of each step's: the 5th percentile lies at rank 4.15, in step 6's
    assert got == harness.arith.percentile(leads, 5) == 6.0


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_readers_find_nothing_without_records(reader):
    assert reader.read(SimpleNamespace(spans=None)) is None
    assert reader.read(SimpleNamespace(spans=[])) is None
    # the harness's context as it stands holds no spans
    assert reader.read(harness.Context({}, {}, "cell", {"steps": 0})) is None
    if reader is host_lead_ms_p5:
        few = [record(s, (1.0, 1.0, 1.0), 2.0) for s in range(spans.SKIP_STEPS)]
        assert reader.read(SimpleNamespace(spans=few)) is None


def test_readers_read_a_traced_cpu_stretch(small):
    from noise_robust_vit_tpu_torch.train import StepTracer

    cpu = torch.device("cpu")
    cfg, mix = small["swin_t"], harness.load_mix("robust")
    state, _ = harness.build_state(cfg, mix, 2**31 + 55, cpu)
    pool = [harness.draw_batch(cfg, 2**31 + 55, i, cpu, getattr(torch, cfg["dtype"]))
            for i in range(2)]
    state.tracer = StepTracer(cpu)
    state.tracer.start()
    for k in range(spans.SKIP_STEPS + 2):
        state.train_step(*pool[k % 2])
    drained = state.tracer.drain()
    ctx = SimpleNamespace(spans=drained["records"])
    assert forward_ms.read(ctx) > 0 and backward_ms.read(ctx) > 0
    assert host_lead_ms_p5.read(ctx) == 0.0  # the events are host clocks on the CPU
    line = spans.log_line(drained)
    assert line.startswith("spans: ms medians forward device ")
    assert f"{spans.SKIP_STEPS + 2} of {spans.SKIP_STEPS + 2} steps traced" in line
    assert "optimizer_end p5 0.0000 p50 0.0000" in line


def test_log_line_without_steps():
    assert spans.log_line({"records": [], "drift_ms": 0.0, "steps": 0}) == \
        "spans: no step traced of 0"


def test_no_card_state_off_the_card():
    t = time.perf_counter()
    assert spans.card_state(torch.device("cpu")) is None
    assert time.perf_counter() - t < 1.0
