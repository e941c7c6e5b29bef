"""The plain reference against the port on the CPU at tiny sizes: in float32
the program's first three train steps (losses, first gradients, changes)
must match the reference's to float32 rounding, in both attention modes,
through Swin's shift, relative-position bias and stochastic depth; and the
reference's pieces against the port's."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.reference import common
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


class CoupledToy:
    """A reference whose model couples the images of a batch: linear →
    BatchNorm over the batch (training statistics) → linear."""

    COUPLES_IMAGES = True

    @staticmethod
    def forward(p, images, masks):
        h = common.linear(images.reshape(images.shape[0], -1), p["a.weight"], p["a.bias"])
        h = F.batch_norm(h, None, None, p["n.weight"], p["n.bias"], training=True)
        return common.linear(h, p["b.weight"], p["b.bias"])


def toy_steps(block):
    shapes = {"a.weight": (16, 12), "a.bias": (16,), "n.weight": (16,), "n.bias": (16,),
              "b.weight": (5, 16), "b.bias": (5,)}
    params = harness.draw_weights(shapes, SEED, CPU)
    gen = torch.Generator().manual_seed(SEED)
    images = torch.randn(8, 2, 2, 3, generator=gen)
    labels = torch.randint(0, 5, (8,), generator=gen)
    opt = {"lr": 1e-3, "weight_decay": 0.05}
    got = common.train_steps(CoupledToy.forward, params, [(images, labels)], opt, block)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = F.cross_entropy(CoupledToy.forward(leaves, images, None), labels,
                           reduction="sum") / 8
    whole = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return got["grads"], whole


def test_a_coupled_reference_steps_over_the_whole_batch():
    block = harness.reference_block({"batch": 8}, CoupledToy)
    assert block == 8
    grads, whole = toy_steps(block)
    assert all(torch.equal(grads[k], whole[k]) for k in whole)
    # the rule matters: blocks of 2 normalise over 2 images
    grads, whole = toy_steps(2)
    assert max(float((grads[k] - whole[k]).norm() / whole[k].norm())
               for k in ("a.weight", "n.weight", "n.bias")) > 1e-3


def test_reference_block_splits_only_an_uncoupled_batch():
    for name in ("simple_vit_b16", "swin_t"):
        cfg = harness.load_config(name)
        assert harness.reference_block(cfg, harness.reference_module(cfg)) == 32
        assert harness.reference_block(cfg, CoupledToy) == cfg["batch"]


def test_reference_block_under_the_tests_smaller_block(small):
    for cfg in small.values():
        assert harness.reference_block(cfg, harness.reference_module(cfg)) == 8
        assert harness.reference_block(cfg, CoupledToy) == cfg["batch"] > 8


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
