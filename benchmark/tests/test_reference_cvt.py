"""The plain CvT reference against the port on the CPU at tiny sizes: in
float32 the program's first three train steps must match the reference's,
robust and vanilla, at 32 px (every stage on the rect Sinkhorn softmax's
plain version or the vector form) and at 112 px (stage 1's 784 queries × 196
keys on the plain streaming version); the reference in blocks of 8 images is
another function, since BatchNorm normalises over the batch; its FLOPs are
the port's count; and the readers of the streaming and rect calls on a
synthetic profile."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import arith, harness
from benchmark.calibrate import half_batch
from benchmark.metrics import rect_ms, rect_roofline_pct, stream_ms, stream_roofline_pct
from benchmark.reference import common
from benchmark.reference import cvt as ref_cvt
from benchmark.trace import STEP_SPAN, Trace

CPU = torch.device("cpu")
SEED = 2**31 + 23
CVT = "bench_test_cvt"


def _register():
    from noise_robust_vit_tpu_torch.models import factory
    from noise_robust_vit_tpu_torch.models.cvt import CvT

    if CVT not in factory._REGISTRY:
        @factory.register_model(CVT)
        def _cvt(num_classes, image_size, robust, dtype, device=None, **kw):
            return CvT(num_classes=num_classes, robust=robust, dtype=dtype, device=device,
                       s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24, s2_heads=1,
                       s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1)


def small_cvt(image_size: int) -> dict:
    """A tiny version of ``configs/cvt_13.json`` (same keys): dims 16/24/32,
    heads 1/1/2 of 64, depth 1 a stage, 16 images of ``image_size`` px."""
    _register()
    cfg = copy.deepcopy(harness.load_config("cvt_13"))
    cfg.update(model=CVT, image_size=image_size, emb_dim=[16, 24, 32], heads=[1, 1, 2],
               depth=[1, 1, 1], num_classes=10, batch=16, dtype="float32")
    return cfg


def readings(cfg, mix, seed=SEED):
    state, weights = harness.build_state(cfg, mix, seed, CPU)
    batches = [harness.draw_batch(cfg, seed, i, CPU, torch.float32) for i in range(3)]
    prog = harness.checked_steps(state, batches, weights)
    return prog, harness.reference_steps(cfg, mix, seed, CPU, 3)


@pytest.mark.parametrize("image", [32, 112])
@pytest.mark.parametrize("mix", ["robust", "vanilla"])
def test_program_in_float32_matches_the_reference(image, mix, monkeypatch):
    from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa

    calls = []
    real = sa.StreamingAttention.apply
    monkeypatch.setattr(sa.StreamingAttention, "apply",
                        lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a))
    prog, ref = readings(small_cvt(image), harness.load_mix(mix))
    # stage 1 at 112 px takes the streaming path, robust only
    want = 3 * [(16, 1, 784, 64)] if image == 112 and mix == "robust" else []
    assert calls == want
    numbers = harness.compare(prog, ref)
    # the first step's loss to float32 rounding; later steps drift with Adam
    assert abs(prog["losses"][0] - ref["losses"][0]) < 1e-5 * ref["losses"][0]
    assert numbers["loss_gap"] < 5e-4
    assert numbers["grad_gap"] < 2e-3
    assert numbers["update_gap"] < 1e-2
    assert all(abs(a - b) > 1e-3 for a, b in zip(ref["losses"], ref["losses"][1:]))


def test_blocks_of_images_are_another_function(monkeypatch):
    # BatchNorm normalises over the images of a block: in blocks of 8 the
    # reference is no longer the program's function, so it steps the batch
    # whole
    cfg = small_cvt(32)
    mix = harness.load_mix("robust")
    assert harness.reference_block(cfg, ref_cvt) == cfg["batch"] == 16
    prog, whole = readings(cfg, mix)
    monkeypatch.setattr(harness, "reference_block", lambda cfg, ref: 8)
    blocks = harness.reference_steps(cfg, mix, SEED, CPU, 3)
    gap = harness.compare(prog, whole)["loss_gap"]
    assert harness.compare(prog, blocks)["loss_gap"] > 100 * gap


def test_reference_parameters_and_flops_are_the_programs():
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.models.cvt import cvt_macs_per_image

    cfg = harness.load_config("cvt_13")
    assert set(harness._param_shapes(cfg)) == ref_cvt.param_names(cfg)
    model = create_model("cvt_13", num_classes=1000, device="meta")
    assert [model.stages[s]["emb_dim"] for s in (1, 2, 3)] == cfg["emb_dim"]
    assert ref_cvt.train_flops_per_image(cfg) == 6 * cvt_macs_per_image(model, 224)
    assert round(ref_cvt.train_flops_per_image(cfg) / 6e9, 4) == 4.5437
    small = small_cvt(112)
    assert set(harness._param_shapes(small)) == ref_cvt.param_names(small)


def test_reference_imports_nothing_of_the_port_or_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ref_cvt))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax", "noise_robust_vit_tpu",
                                       "noise_robust_vit_tpu_torch") for n in names)


# ------------------------------------------------- the cell's comparison

FAULT_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def unchanged(state) -> None:
    """Fault: the step computes its loss and gradients, and updates nothing."""
    state.optimizer.step = lambda *a, **k: None


@pytest.fixture
def tiny_cell(monkeypatch):
    """``cvt_13.robust`` run on the CPU with the tiny CvT at 32 px in place
    of CvT-13, judged by the cell's own limits."""
    cfg = small_cvt(32)
    monkeypatch.setattr(harness, "load_config", lambda name: cfg)
    return cfg


def run(seed, fault=None):
    return harness.run_cell("cvt_13.robust", seed, 0.2, False, "cpu", time.perf_counter(),
                            fault=fault)


def test_sound_run_is_correct(tiny_cell):
    # in float32: the limits were set from bf16 readings at the cell's size,
    # where the median leaf's gap (1.2e-3 at the median seed) is a fourth of
    # the tiny bf16 model's
    r = run(FAULT_SEEDS[0])
    assert r["correct"], r["checks"]
    assert r["checks"]["loss_gap"]["limit"] is None
    assert r["checks"]["update_gap_median"]["value"] < 1e-4


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["unchanged", "half_batch"])
def test_broken_step_is_not_correct(tiny_cell, fault):
    tiny_cell["dtype"] = "bfloat16"
    r = run(FAULT_SEEDS[1], fault)
    assert not r["correct"], r["checks"]


def test_control_fails_a_limit(tiny_cell):
    tiny_cell["dtype"] = "bfloat16"
    mix, limits = harness.load_mix("robust"), harness.load_limits("cvt_13.robust")
    for seed in FAULT_SEEDS:
        ref = harness.reference_steps(tiny_cell, mix, seed, CPU, 3)
        control = harness.reference_steps(tiny_cell, mix, seed, CPU, 3, common.fp8)
        ok, checks = harness.judge(harness.compare(control, ref), limits)
        assert not ok, checks


# ---------------------------------------------------------------- readers

def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def cvt_trace(streams=3, rects=10, steps=2):
    """``steps`` profiled steps, each with ``streams`` streaming calls (a
    4 µs forward kernel and a 10 µs backward one) and ``rects`` rect calls
    (1 µs and 2 µs), the backward on the autograd thread, and a 5 µs GEMM
    outside them."""
    ev, corr = [], 0

    def call(name, t, dur, tid, wrapper=False):
        nonlocal corr
        if wrapper:
            ev.append(_ev("cpu_op", f"autograd::engine::evaluate_function: {name}", t, 4,
                          tid=tid))
        ev.append(_ev("cpu_op", name, t + 1, 3, tid=tid))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 2, 1, tid=tid, corr=corr))
        ev.append(_ev("kernel", f"k_{name}", t + 2, dur, tid=7, corr=corr))
        corr += 1

    for k in range(steps):
        t0 = 10_000 * k
        ev.append(_ev("user_annotation", STEP_SPAN, t0, 9_000))
        t = t0 + 10
        for _ in range(streams):
            call("StreamingAttention", t, 4, 1)
            t += 20
        for _ in range(rects):
            call("SinkhornSoftmaxRect", t, 1, 1)
            t += 20
        call("aten::mm", t, 5, 1)
        t += 20
        for _ in range(rects):
            call("SinkhornSoftmaxRectBackward", t, 2, 2, wrapper=True)
            t += 20
        for _ in range(streams):
            call("StreamingAttentionBackward", t, 10, 2, wrapper=True)
            t += 20
    return Trace(ev, steps)


def context(trace, cfg=None, mix="robust"):
    cfg = cfg or harness.load_config("cvt_13")
    return harness.Context(cfg, harness.load_mix(mix), "cvt_13.robust", {"steps": 0}, trace)


def test_kind_readers_read_their_functions_device_time():
    ctx = context(cvt_trace())
    assert stream_ms.read(ctx) == pytest.approx(3 * 14e-3)
    assert rect_ms.read(ctx) == pytest.approx(10 * 3e-3)
    calls = harness.load_config("cvt_13")["attention"]["sinkhorn"]["calls"]
    stream_bound = arith.step_attention_bound_ms(calls[:2], True, 3, True)
    rect_bound = arith.step_attention_bound_ms(calls[2:], True, 3, True)
    # CvT-13's step: 0.7538 ms of the streaming calls, 0.4574 ms of the rect ones
    assert stream_bound == pytest.approx(0.7538, rel=2e-3)
    assert rect_bound == pytest.approx(0.4574, rel=5e-3)
    assert stream_roofline_pct.read(ctx) == pytest.approx(100 * stream_bound / 42e-3)
    assert rect_roofline_pct.read(ctx) == pytest.approx(100 * rect_bound / 30e-3)


@pytest.mark.parametrize("reader,streams,rects", [
    (stream_roofline_pct, 2, 10), (stream_roofline_pct, 4, 10),
    (rect_roofline_pct, 3, 9), (rect_roofline_pct, 3, 11)])
def test_roofline_readers_hold_the_configured_call_counts(reader, streams, rects):
    with pytest.raises(RuntimeError, match="not (3|10) each"):
        reader.read(context(cvt_trace(streams, rects)))


@pytest.mark.parametrize("reader", [stream_ms, stream_roofline_pct, rect_ms, rect_roofline_pct],
                         ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_kind_readers_find_nothing_where_no_call_was_made(reader):
    # no call in the profile: the op left the path
    assert reader.read(context(cvt_trace(0, 0))) is None
    # a configuration without calls of the kind, or a mix without kernels
    for name in ("simple_vit_b16", "swin_t"):
        assert reader.read(context(cvt_trace(), harness.load_config(name))) is None
    assert reader.read(context(cvt_trace(), mix="vanilla")) is None


def test_a_kind_takes_one_list_of_functions():
    cfg = copy.deepcopy(harness.load_config("cvt_13"))
    cfg["attention"]["sinkhorn"]["calls"][1]["functions"] = ["StreamingAttention"]
    with pytest.raises(RuntimeError, match="2 lists"):
        stream_ms.read(context(cvt_trace(), cfg))
    assert rect_ms.read(context(cvt_trace(), cfg)) == pytest.approx(30e-3)
