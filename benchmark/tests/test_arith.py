"""The harness's arithmetic on the CPU: the analytic FLOPs and attention
bounds against the values the port's smoke script printed on the card, the
percentile, spread and interval code on synthetic lists, and the trace
reduction on a synthetic Chrome trace."""

from __future__ import annotations

import statistics

import pytest

from benchmark import arith, harness
from benchmark.reference import simple_vit, swin
from benchmark.trace import STEP_SPAN, Trace


def test_vit_train_flops_match_the_smoke_count():
    # chip_smoke.py::vit_train_flops_per_image() at SimpleViT-B/16 @224
    assert simple_vit.train_flops_per_image(harness.load_config("simple_vit_b16")) \
        == 104829898752


def test_swin_t_macs_are_torchvision_s_4_49_g():
    macs = swin.train_flops_per_image(harness.load_config("swin_t")) / 6
    assert round(macs / 1e9, 4) == 4.4906


@pytest.mark.parametrize("robust,fwd,bwd", [(True, 0.0971, 0.1661), (False, 0.0927, 0.1618)])
def test_packed_bound_matches_the_kernel_table(robust, fwd, bwd):
    call = harness.load_config("simple_vit_b16")["attention"]["sinkhorn"]["calls"][0]
    (f, fby), (b, bby) = arith.call_bounds(call, robust, 3, True)
    assert (round(f, 4), round(b, 4), fby, bby) == (fwd, bwd, "bytes", "bytes")


@pytest.mark.parametrize("robust,fwd,bwd", [(True, 0.1026, 0.1722), (False, 0.0940, 0.1636)])
def test_windowed_bound_matches_the_kernel_table(robust, fwd, bwd):
    # Swin-T stage 0 [8192, 3, 49, 32], nW 64 (PERF.md's kernel table, row 3)
    call = harness.load_config("swin_t")["attention"]["sinkhorn"]["calls"][0]
    (f, _), (b, _) = arith.call_bounds(call, robust, 3, True)
    assert (round(f, 4), round(b, 4)) == (fwd, bwd)


# PERF.md's kernel table, rows 7 and 5, robust (3, final): CvT-13 @224 b128
# stage 1 and 2 on the streaming kernels, stage 3 on the rect ones
CVT_13_CALLS = [
    ({"kind": "streaming", "batch": 128, "heads": 1, "tokens": 3136, "keys": 784, "dim": 64},
     0.1566, 0.3900),
    ({"kind": "streaming", "batch": 128, "heads": 3, "tokens": 784, "keys": 196, "dim": 64},
     0.0305, 0.0731),
    ({"kind": "rect", "batch": 128, "heads": 6, "tokens": 196, "keys": 49}, 0.0185, 0.0273),
]


@pytest.mark.parametrize("call,fwd,bwd", CVT_13_CALLS,
                         ids=["streaming stage 1", "streaming stage 2", "rect stage 3"])
def test_cvt_13_bounds_match_the_kernel_table(call, fwd, bwd):
    (f, _), (b, _) = arith.call_bounds(dict(call, count=1), True, 3, True)
    assert f == pytest.approx(fwd, rel=5e-3) and b == pytest.approx(bwd, rel=5e-3)


def test_an_unknown_call_kind_is_refused():
    call = dict(CVT_13_CALLS[0][0], kind="sparse")
    with pytest.raises(ValueError, match="sparse"):
        arith.call_bounds(call, True, 3, True)


def test_step_bounds():
    v = harness.load_config("simple_vit_b16")["attention"]["sinkhorn"]["calls"]
    s = harness.load_config("swin_t")["attention"]["sinkhorn"]["calls"]
    assert arith.step_attention_bound_ms(v, True, 3, True) == pytest.approx(12 * 0.26313, 1e-3)
    assert arith.step_attention_bound_ms(s, True, 3, True) == pytest.approx(1.3055, 1e-3)


def test_residual_rows():
    assert arith.residual_rows(True, 3, True) == 7
    assert arith.residual_rows(True, 4, False) == 8
    assert arith.residual_rows(False, 3, True) == 1


def test_percentile_interpolates_like_numpy():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    assert arith.percentile([5.0], 95) == 5.0
    assert arith.percentile([3, 1, 2], 50) == 2
    # a stall in 1 step of 200 is above the 95th percentile, 20 of 200 are not
    steps = [100.0] * 199 + [400.0]
    assert arith.percentile(steps, 95) == 100.0
    steps = [100.0] * 180 + [150.0] * 20
    assert arith.percentile(steps, 95) == 150.0
    with pytest.raises(ValueError):
        arith.percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == pytest.approx((q3 - q1) / 12.5)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert arith.union_length(iv) == 5
    assert arith.union_length([]) == 0
    assert arith.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert arith.gaps(iv, -1, 4) == [(-1, 0), (3, 4)]
    assert arith.gaps([], 0, 1) == [(0, 1)]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic_trace():
    """Two steps: host ops on thread 1 (forward, optimizer) and 2 (backward),
    launches by correlation id, and kernels on the device timeline."""
    ev = []
    for k, t0 in enumerate((0, 100)):
        ev.append(_ev("user_annotation", STEP_SPAN, t0, 60))
        ev.append(_ev("cpu_op", "PackedAttention", t0 + 1, 5))
        ev.append(_ev("cpu_op", "aten::mm", t0 + 10, 5))
        ev.append(_ev("cpu_op", "autograd::engine::evaluate_function: PackedAttentionBackward",
                      t0 + 20, 10, tid=2))
        ev.append(_ev("cpu_op", "PackedAttentionBackward", t0 + 21, 8, tid=2))
        ev.append(_ev("user_annotation", "Optimizer.step#AdamW.step", t0 + 40, 10))
        ev.append(_ev("cpu_op", "aten::_foreach_add_", t0 + 41, 5))
        for j, (tid, ts) in enumerate(((1, t0 + 2), (1, t0 + 11), (2, t0 + 22), (1, t0 + 42))):
            corr = 10 * k + j
            ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr))
        ev.append(_ev("kernel", "nrv::packed_fwd", t0 + 3, 4, tid=7, corr=10 * k))
        ev.append(_ev("kernel", "gemm", t0 + 12, 6, tid=7, corr=10 * k + 1))
        ev.append(_ev("kernel", "nrv::packed_bwd", t0 + 23, 10, tid=7, corr=10 * k + 2))
        ev.append(_ev("kernel", "adam", t0 + 50, 2, tid=7, corr=10 * k + 3))
    return ev


def test_trace_attributes_device_time_to_the_enclosing_host_ops():
    t = Trace(synthetic_trace(), 2)
    assert t.device_ms() == pytest.approx(22e-3)
    assert t.device_ms(["PackedAttention", "PackedAttentionBackward"]) == pytest.approx(14e-3)
    assert t.device_ms(["PackedAttentionBackward"]) == pytest.approx(10e-3)
    assert t.device_ms(["Optimizer.step#AdamW.step"]) == pytest.approx(2e-3)
    assert t.host_op_count("PackedAttention") == 1
    assert t.host_op_count("PackedAttentionBackward") == 1
    assert t.kernels_per_step() == 4


def test_trace_idle_share_and_breakdown():
    t = Trace(synthetic_trace(), 2)
    assert t.window_s == pytest.approx(160e-6)
    assert t.busy_s == pytest.approx(44e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["nrv::packed_bwd", pytest.approx(20e-6)]
    gaps = dict(b["idle_gaps"])
    # the wait before each step's optimizer kernel is labelled by its host op
    assert gaps["aten::_foreach_add_"] == pytest.approx(2 * 17e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_trace_refuses_a_wrong_step_count():
    with pytest.raises(RuntimeError):
        Trace(synthetic_trace(), 3)


def test_idle_share_comes_from_the_device_only_profile_when_there_is_one():
    # the same kernels, 1 µs apart: the host no longer held them apart
    timeline, t0 = [], 1000.0
    for e in sorted((e for e in synthetic_trace() if e["cat"] == "kernel"),
                    key=lambda e: e["ts"]):
        timeline.append(dict(e, ts=t0))
        t0 += e["dur"] + 1
    t = Trace(synthetic_trace(), 2, timeline)
    assert t.busy_s == pytest.approx(44e-6)
    assert t.window_s == pytest.approx(51e-6)
    # attribution still comes from the profile with host ops
    assert t.device_ms(["PackedAttentionBackward"]) == pytest.approx(10e-3)


def test_idle_share_is_over_the_stretch_step_events():
    # busy time and span from the same profiled steps: the stretch's step
    # events no longer enter, so a stretch faster than the profiled steps
    # cannot turn the share negative
    from benchmark.harness import Context
    from benchmark.metrics import device_idle_pct
    from benchmark.trace import DEVICE_CATS

    t = Trace(synthetic_trace(), 2)
    stretch = {"steps": 3, "step_ms": [0.040, 0.048, 0.044], "wall_s": 3 * 66e-6}
    idle = 100.0 * (1.0 - 44.0 / 160.0)
    assert device_idle_pct.read(Context({}, {}, "w", stretch, t)) == pytest.approx(idle)
    fast = dict(stretch, step_ms=[0.001] * 3)
    assert device_idle_pct.read(Context({}, {}, "w", fast, t)) == pytest.approx(idle)
    # with a device-only profile, its own busy time over its own span
    timeline, t0 = [], 1000.0
    for e in sorted((e for e in synthetic_trace() if e["cat"] == "kernel"),
                    key=lambda e: e["ts"]):
        timeline.append(dict(e, ts=t0))
        t0 += e["dur"] + 1
    t = Trace(synthetic_trace(), 2, timeline)
    assert device_idle_pct.read(Context({}, {}, "w", stretch, t)) == \
        pytest.approx(100.0 * (1.0 - 44.0 / 51.0))
    bare = Trace([e for e in synthetic_trace() if e.get("cat") not in DEVICE_CATS], 2)
    assert device_idle_pct.read(Context({}, {}, "w", stretch, bare)) is None


def test_device_step_ms_is_the_device_only_busy_time_a_step(monkeypatch):
    # an untraced run's device_step_ms is the union of the device-only
    # profile's device ops over the profiled steps: overlaps counted once,
    # gaps and host events left out; None off the card
    import torch

    from benchmark import trace

    timeline = [_ev("kernel", "a", 0, 10), _ev("kernel", "b", 5, 10),
                _ev("gpu_memcpy", "c", 30, 4), _ev("cpu_op", "aten::mm", 0, 100),
                _ev("kernel", "d", 60, 6)]
    monkeypatch.setattr(trace, "_device_timeline", lambda *a: timeline)
    cuda = torch.device("cuda")
    assert trace.device_step_ms(None, None, 2, cuda) == pytest.approx(25e-3 / 2)
    monkeypatch.setattr(trace, "_device_timeline", lambda *a: [])
    assert trace.device_step_ms(None, None, 2, cuda) is None
    assert trace.device_step_ms(None, None, 2, torch.device("cpu")) is None


def test_device_mfu_is_the_step_flops_over_the_device_busy_time():
    from benchmark.harness import Context, load_config
    from benchmark.metrics import device_mfu, wall_img_s
    from benchmark.trace import DEVICE_CATS

    cfg = load_config("simple_vit_b16")
    t = Trace(synthetic_trace(), 2)
    stretch = {"steps": 3, "images": 3 * cfg["batch"], "wall_s": 0.3, "step_ms": [100.0] * 3}
    flops = simple_vit.train_flops_per_image(cfg) * cfg["batch"]
    want = 100.0 * flops / (t.busy_s / 2) / arith.PEAK_BF16
    assert device_mfu.read(Context(cfg, {}, "w", stretch, t)) == pytest.approx(want)
    bare = Trace([e for e in synthetic_trace() if e.get("cat") not in DEVICE_CATS], 2)
    assert device_mfu.read(Context(cfg, {}, "w", stretch, bare)) is None
    # the wall rate is the stretch's, whatever the profile holds
    assert wall_img_s.read(Context(cfg, {}, "w", stretch, bare)) == \
        pytest.approx(10 * cfg["batch"])
    assert wall_img_s.read(Context(cfg, {}, "w", dict(stretch, steps=0), t)) is None
