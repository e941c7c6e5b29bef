"""The plain LeViT reference against the port on the CPU at tiny sizes: in
float32 the program's first three train steps must match the reference's,
robust and vanilla, at 144 px (stage 0's 81 tokens on the plain biased
version with v twice as wide as q and k, the subsamples on the rect
Sinkhorn softmax's); the reference in blocks of 8 images is another
function, since BatchNorm normalises over the batch; its FLOPs are the
port's count; the biased calls' bound is the windowed one where v is as
wide as q and k, and the kernel table's at LeViT-128S's stage 0; the
readers of the biased calls on a synthetic profile; and the cell's own
limits on the tiny model: a sound run is correct, a step that updates
nothing is not."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import arith, harness
from benchmark.metrics import _biased_bound, biased_ms, biased_roofline_pct
from benchmark.reference import common
from benchmark.reference import levit as ref_levit
from benchmark.trace import STEP_SPAN, Trace

CPU = torch.device("cpu")
SEED = 2**31 + 29
LEVIT = "bench_test_levit"
D = 16
EMBED = (32, 48, 64)


def _register():
    from noise_robust_vit_tpu_torch.models import factory
    from noise_robust_vit_tpu_torch.models.levit import LeViT

    if LEVIT not in factory._REGISTRY:
        @factory.register_model(LEVIT)
        def _levit(num_classes, image_size, robust, dtype, device=None, **kw):
            return LeViT(img_size=image_size, patch_size=16, num_classes=num_classes,
                         embed_dim=EMBED, key_dim=(D,) * 3, depth=(1, 1, 1),
                         num_heads=(2, 3, 4), attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
                         down_ops=(("Subsample", D, EMBED[0] // D, 4, 2, 2),
                                   ("Subsample", D, EMBED[1] // D, 4, 2, 2)),
                         robust=robust, dtype=dtype, device=device)


def small_levit(image_size: int = 144) -> dict:
    """A tiny version of ``configs/levit_128s.json`` (same keys): dims
    32/48/64, heads 2/3/4 of key width 16 and value width 32, one block a
    stage, subsamples of 2 and 3 heads with values 64 wide, 16 images of
    ``image_size`` px."""
    _register()
    cfg = copy.deepcopy(harness.load_config("levit_128s"))
    cfg.update(model=LEVIT, image_size=image_size, embed_dim=list(EMBED), heads=[2, 3, 4],
               depth=[1, 1, 1], num_classes=10, batch=16, dtype="float32")
    for sub, dim in zip(cfg["subsample"], EMBED):
        sub["heads"] = dim // D
    return cfg


def readings(cfg, mix, seed=SEED):
    state, weights = harness.build_state(cfg, mix, seed, CPU)
    batches = [harness.draw_batch(cfg, seed, i, CPU, torch.float32) for i in range(3)]
    prog = harness.checked_steps(state, batches, weights)
    return prog, harness.reference_steps(cfg, mix, seed, CPU, 3)


@pytest.mark.parametrize("mix", ["robust", "vanilla"])
def test_program_in_float32_matches_the_reference(mix, monkeypatch):
    from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba
    from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss

    calls, rects = [], []
    real, real_rect = ba.BiasedAttention.apply, ss.SinkhornSoftmaxRect.apply
    monkeypatch.setattr(ba.BiasedAttention, "apply",
                        lambda q, k, v, *a: calls.append((tuple(q.shape), v.shape[-1]))
                        or real(q, k, v, *a))
    monkeypatch.setattr(ss.SinkhornSoftmaxRect, "apply",
                        lambda x, *a: rects.append(tuple(x.shape)) or real_rect(x, *a))
    prog, ref = readings(small_levit(), harness.load_mix(mix))
    # robust: the square attention on the biased path at 81, 25 and 9
    # tokens (v 32 wide, q and k 16), the subsamples' 25 × 81 and 9 × 25
    # logits on the rect softmax; three steps
    robust = mix == "robust"
    want = [((16, 2, 81, D), 2 * D), ((16, 3, 25, D), 2 * D), ((16, 4, 9, D), 2 * D)]
    assert calls == (3 * want if robust else [])
    assert rects == (3 * [(16, 2, 25, 81), (16, 3, 9, 25)] if robust else [])
    numbers = harness.compare(prog, ref)
    # the first step's loss to float32 rounding; later steps drift with Adam
    assert abs(prog["losses"][0] - ref["losses"][0]) < 1e-5 * ref["losses"][0]
    assert numbers["loss_gap"] < 5e-4
    assert numbers["grad_gap"] < 2e-3
    # vanilla at this size is ill-conditioned: the reference's own float32
    # first gradient is 1.7e-4 off its float64 one on the worst leaf (robust
    # 1.6e-5), and three Adam steps carry that to ~1.1% of that leaf's
    # change (robust 2.7e-5)
    assert numbers["update_gap"] < (1e-2 if robust else 2e-2)
    assert all(abs(a - b) > 1e-3 for a, b in zip(ref["losses"], ref["losses"][1:]))


def test_blocks_of_images_are_another_function(monkeypatch):
    # BatchNorm normalises over the images of a block: in blocks of 8 the
    # reference is no longer the program's function, so it steps the batch
    # whole
    cfg = small_levit()
    mix = harness.load_mix("robust")
    assert harness.reference_block(cfg, ref_levit) == cfg["batch"] == 16
    prog, whole = readings(cfg, mix)
    monkeypatch.setattr(harness, "reference_block", lambda cfg, ref: 8)
    blocks = harness.reference_steps(cfg, mix, SEED, CPU, 3)
    gap = harness.compare(prog, whole)["loss_gap"]
    assert harness.compare(prog, blocks)["loss_gap"] > 100 * gap


def test_reference_parameters_and_flops_are_the_programs():
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.models.levit import levit_macs_per_image

    cfg = harness.load_config("levit_128s")
    assert set(harness._param_shapes(cfg)) == ref_levit.param_names(cfg)
    model = create_model(cfg["model"], num_classes=1000, device="meta")
    assert list(model.embed_dim) == cfg["embed_dim"]
    assert list(model.num_heads) == cfg["heads"] and list(model.depth) == cfg["depth"]
    assert [(do[1], do[2], do[3], do[4], do[5]) for do in model.down_ops] == [
        (s["key_dim"], s["heads"], s["attn_ratio"], s["mlp_ratio"], s["stride"])
        for s in cfg["subsample"]]
    assert ref_levit.train_flops_per_image(cfg) == 6 * levit_macs_per_image(model)
    assert round(ref_levit.train_flops_per_image(cfg) / 6e9, 5) == 0.30428
    small = small_levit()
    assert set(harness._param_shapes(small)) == ref_levit.param_names(small)
    tiny = create_model(small["model"], num_classes=10, image_size=144, device="meta")
    assert ref_levit.train_flops_per_image(small) == 6 * levit_macs_per_image(tiny)


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (2, 2, 16, 49), (1, 2, 49, 49)])
def test_sinkhorn_is_the_programs_where_keys_starve(shape):
    # logits spread over ±450, as LeViT-128S's last stage reads on some
    # seeds: some columns of the softmax are 0 in float32, others far under
    # the 1e-8 floor. The literal rewrites give NaN there; the reference's
    # scalings are the program's weights and gradients
    from noise_robust_vit_tpu_torch.ops.sinkhorn import robust_softmax

    gen = torch.Generator().manual_seed(5)
    logits = 150.0 * torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen)
    cols = torch.softmax(logits, -1).sum(-2)
    assert (cols == 0).any() and ((cols > 0) & (cols < 1e-8)).any()
    assert not torch.isfinite(common.attention_weights(logits, True)).all()
    x1, x2 = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    want, got = robust_softmax(x1, robust=True), ref_levit.attention_weights(x2, True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    (want * g).sum().backward()
    (got * g).sum().backward()
    assert torch.isfinite(x2.grad).all()
    # the two backward orders meet scalings up to 1e8 at the starved keys,
    # where their rounding differs by up to 1.1e-4 of the largest gradient
    scale = float(x1.grad.abs().max())
    torch.testing.assert_close(x2.grad, x1.grad, atol=2e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("side,side_,stride", [(14, 14, 1), (7, 7, 1), (14, 7, 2), (7, 4, 2)])
def test_bias_index_is_the_ports(side, side_, stride):
    from noise_robust_vit_tpu_torch.models import levit

    want = (levit._bias_index_square(side) if stride == 1
            else levit._bias_index_subsample(side, side_, stride))[0]
    assert torch.equal(ref_levit.bias_index(side, side_, stride), torch.from_numpy(want))


@pytest.mark.parametrize("module", [ref_levit, _biased_bound, biased_ms, biased_roofline_pct],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_reference_and_readers_import_nothing_of_the_port_or_jax(module):
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax", "noise_robust_vit_tpu",
                                       "noise_robust_vit_tpu_torch") for n in names)


# ------------------------------------------------- the cell's comparison

FAULT_SEED = 2**31 + 101


def unchanged(state) -> None:
    """Fault: the step computes its loss and gradients, and updates nothing."""
    state.optimizer.step = lambda *a, **k: None


@pytest.fixture
def tiny_cell(monkeypatch):
    """``levit_128s.robust`` run on the CPU with the tiny LeViT at 144 px in
    place of LeViT-128S, judged by the cell's own limits."""
    cfg = small_levit()
    monkeypatch.setattr(harness, "load_config", lambda name: cfg)
    return cfg


def run(seed, fault=None):
    return harness.run_cell("levit_128s.robust", seed, 0.2, False, "cpu",
                            time.perf_counter(), fault=fault)


def test_sound_run_is_correct(tiny_cell):
    r = run(FAULT_SEED)
    assert r["correct"], r["checks"]
    # the limits compare the change alone: under the weight draw no limit
    # separates bf16 from the fp8 control on every seed
    assert r["checks"]["loss_gap"]["limit"] is None
    assert r["checks"]["grad_gap"]["limit"] is None
    assert r["checks"]["update_gap_median"]["value"] < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_step_that_updates_nothing_is_not_correct(tiny_cell, dtype):
    tiny_cell["dtype"] = dtype
    r = run(FAULT_SEED, unchanged)
    assert not r["correct"], r["checks"]
    assert r["checks"]["update_gap"]["value"] == 1.0


# ------------------------------------------------------------------ bound

@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("shape", [(256, 4, 196, 16), (64, 3, 49, 32), (8, 8, 16, 64)])
def test_biased_bound_is_the_windowed_one_where_v_is_as_wide(robust, shape):
    b, h, n, d = shape
    windowed = {"kind": "windowed", "windows_total": b, "windows": 1, "heads": h,
                "tokens": n, "dim": d}
    biased = {"kind": "biased", "batch": b, "heads": h, "tokens": n, "dim": d, "dim_v": d}
    assert (_biased_bound.call_bounds(biased, robust, 3, True)
            == arith.call_bounds(windowed, robust, 3, True))


def test_biased_bound_matches_the_kernel_table():
    # PERF.md's row 3, LeViT-128S stage 0 on the shared-memory branch:
    # [256,4,196,16], DV 32, one [1,4,196,196] float32 bias; both directions
    # bound by their operations
    call = {"batch": 256, "heads": 4, "tokens": 196, "dim": 16, "dim_v": 32}
    (f, fby), (b, bby) = _biased_bound.call_bounds(call, True, 3, True)
    assert (round(f, 4), round(b, 4), fby, bby) == (0.0138, 0.0302, "operations", "operations")
    # v twice as wide moves more than the windowed count with q's width
    same = dict(call, dim_v=16)
    assert _biased_bound.call_bounds(same, True, 3, True)[0][0] < f
    calls = [c for c in harness.load_config("levit_128s")["attention"]["sinkhorn"]["calls"]
             if c["kind"] == "biased"]
    assert [c["count"] for c in calls] == [2, 3, 4]
    # LeViT-128S's step: 0.1488 ms of the biased calls
    assert _biased_bound.step_bound_ms(calls, True, 3, True) == pytest.approx(0.14878, rel=1e-4)


# ---------------------------------------------------------------- readers

def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def levit_trace(biased=9, rects=2, steps=2):
    """``steps`` profiled steps, each with ``biased`` biased calls (a 3 µs
    forward kernel and an 8 µs backward one) and ``rects`` rect calls (1 µs
    and 2 µs), the backward on the autograd thread, and a 5 µs GEMM
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
        for _ in range(biased):
            call("BiasedAttention", t, 3, 1)
            t += 20
        for _ in range(rects):
            call("SinkhornSoftmaxRect", t, 1, 1)
            t += 20
        call("aten::mm", t, 5, 1)
        t += 20
        for _ in range(rects):
            call("SinkhornSoftmaxRectBackward", t, 2, 2, wrapper=True)
            t += 20
        for _ in range(biased):
            call("BiasedAttentionBackward", t, 8, 2, wrapper=True)
            t += 20
    return Trace(ev, steps)


def context(trace, cfg=None, mix="robust"):
    cfg = cfg or harness.load_config("levit_128s")
    return harness.Context(cfg, harness.load_mix(mix), "levit_128s.robust", {"steps": 0},
                           trace)


def test_biased_readers_read_their_functions_device_time():
    ctx = context(levit_trace())
    assert biased_ms.read(ctx) == pytest.approx(9 * 11e-3)
    assert biased_roofline_pct.read(ctx) == pytest.approx(100 * 0.14878 / 99e-3, rel=1e-4)


@pytest.mark.parametrize("biased", [8, 10])
def test_biased_roofline_holds_the_configured_call_count(biased):
    with pytest.raises(RuntimeError, match="not 9 each"):
        biased_roofline_pct.read(context(levit_trace(biased)))


@pytest.mark.parametrize("reader", [biased_ms, biased_roofline_pct],
                         ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_biased_readers_find_nothing_where_no_call_was_made(reader):
    # no call in the profile: the op left the path
    assert reader.read(context(levit_trace(0, 0))) is None
    # a configuration without calls of the kind, or a mix without kernels
    for name in ("simple_vit_b16", "swin_t", "cvt_13"):
        assert reader.read(context(levit_trace(), harness.load_config(name))) is None
    assert reader.read(context(levit_trace(), mix="vanilla")) is None
