"""The plain reference against the port on the CPU at tiny sizes: in float32
the program's first three train steps (losses, first gradients, changes)
must match the reference's to float32 rounding, in both attention modes,
through Swin's shift, relative-position bias and stochastic depth; and the
reference's pieces against the port's."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.reference import swin as ref_swin

CPU = torch.device("cpu")
SEED = 2**31 + 11


def readings(cfg, mix, seed, dtype):
    cfg = dict(cfg, dtype=dtype)
    state, weights = harness.build_state(cfg, mix, seed, CPU)
    batches = [harness.draw_batch(cfg, seed, i, CPU, getattr(torch, dtype)) for i in range(3)]
    prog = harness.checked_steps(state, batches, weights)
    return prog, harness.reference_steps(cfg, mix, seed, CPU, 3)


@pytest.mark.parametrize("config", ["simple_vit_b16", "swin_t"])
@pytest.mark.parametrize("mix", ["robust", "vanilla"])
def test_program_in_float32_matches_the_reference(small, config, mix):
    prog, ref = readings(small[config], harness.load_mix(mix), SEED, "float32")
    numbers = harness.compare(prog, ref)
    # the first step's loss to float32 rounding; later steps drift with Adam
    assert abs(prog["losses"][0] - ref["losses"][0]) < 1e-5 * ref["losses"][0]
    assert numbers["loss_gap"] < 5e-4
    assert numbers["grad_gap"] < 2e-3
    assert numbers["update_gap"] < 1e-2
    assert all(abs(a - b) > 1e-3 for a, b in zip(ref["losses"], ref["losses"][1:]))


@pytest.mark.parametrize("mix", ["robust", "vanilla"])
def test_stochastic_depth_draws_are_the_programs(small, mix):
    cfg, m = small["swin_t"], harness.load_mix(mix)
    masks = harness.draw_masks(cfg, SEED, 3, CPU)
    assert len(masks) == 3 and len(masks[0]) == len(ref_swin.drop_rates(cfg)) > 0
    assert any(bool((x == 0).any()) for step in masks for x in step)
    # without the draws the reference is another function
    prog, ref = readings(cfg, m, SEED, "float32")
    calls = []
    real = harness.draw_masks
    harness.draw_masks = lambda *a: calls.append(a) or None
    try:
        plain = harness.reference_steps(dict(cfg, dtype="float32"), m, SEED, CPU, 3)
    finally:
        harness.draw_masks = real
    assert calls
    assert harness.compare(prog, plain)["loss_gap"] > 100 * harness.compare(prog, ref)["loss_gap"]


def test_swin_geometry_matches_the_port():
    from noise_robust_vit_tpu_torch.ops.windows import relative_position_index, shift_attn_mask

    for w in (4, 7):
        assert torch.equal(ref_swin.relative_index(w),
                           torch.from_numpy(relative_position_index(w, w)))
    for side, w in ((8, 4), (56, 7), (14, 7)):
        got = ref_swin.shift_mask(side, w, w // 2)
        want = torch.from_numpy(shift_attn_mask(side, side, (w, w), (w // 2, w // 2)))
        assert torch.equal(got, want)


def test_reference_parameters_are_the_programs():
    for name in ("simple_vit_b16", "swin_t"):
        cfg = harness.load_config(name)
        assert set(harness._param_shapes(cfg)) == harness.reference_module(cfg).param_names(cfg)


def test_weights_depend_on_the_seed_alone():
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "n.weight": (4,), "t.table": (5, 2)}
    w1 = harness.draw_weights(shapes, 2**40 + 3, CPU)
    w2 = harness.draw_weights(dict(reversed(list(shapes.items()))), 2**40 + 3, CPU)
    w3 = harness.draw_weights(shapes, 2**40 + 4, CPU)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert (w1["n.weight"] - 1).abs().max() < 0.2 and w1["a.bias"].abs().max() < 0.2


def test_batches_differ_and_repeat():
    cfg = dict(harness.load_config("swin_t"), batch=3, image_size=8)
    a = harness.draw_batch(cfg, 5, 0, CPU, torch.bfloat16)
    b = harness.draw_batch(cfg, 5, 1, CPU, torch.bfloat16)
    again = harness.draw_batch(cfg, 5, 0, CPU, torch.bfloat16)
    assert a[0].shape == (3, 8, 8, 3) and a[0].dtype == torch.bfloat16
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])
    assert not torch.equal(a[0], b[0])
    assert int(a[1].max()) < cfg["num_classes"]


def test_program_must_run_the_references_optimizer_and_schedule(small, monkeypatch):
    from benchmark.reference import common

    cfg, mix = small["simple_vit_b16"], harness.load_mix("robust")
    harness.build_state(cfg, mix, SEED, CPU)
    monkeypatch.setattr(common, "ADAMW_EPS", 1e-6)
    with pytest.raises(RuntimeError, match="AdamW"):
        harness.build_state(cfg, mix, SEED, CPU)
    monkeypatch.undo()
    monkeypatch.setattr(harness, "load_config", lambda name: small[name])
    with pytest.raises(RuntimeError, match="Sinkhorn"):
        harness.build_state(dict(cfg, sinkhorn={"iters": 4, "final_row_norm": True}),
                            mix, SEED, CPU)
