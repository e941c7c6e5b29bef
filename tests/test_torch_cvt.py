"""The port's CvT slice against the JAX package, on the CPU in float32.

A small JAX ``CvT`` (dims 16/24/32, heads 1/1/2 of 64, depth 1 a stage) is
initialized, every parameter and batch statistic is perturbed from a numpy
seed, and the variables are carried across with ``convert_params``
(params and ``batch_stats``). Train mode compares the logits, every
parameter gradient of the mean cross-entropy and the updated
``batch_stats``, robust and vanilla, at 32 px (every robust stage takes the
rectangular Sinkhorn softmax's plain version or the vector form) and at
112 px, where stage 1 (784 queries × 196 keys) takes the port's plain
streaming version and JAX its vector form (off the TPU JAX takes no Pallas
kernel). Tolerances: logits atol 1e-5, gradients and statistics atol 5e-5
and rtol 1e-4 (LeViT's file uses 1e-4: BatchNorm over four images divides
by batch standard deviations and amplifies the float32 rounding of sums
that run in another order in the two packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from noise_robust_vit_tpu.models import cvt as jax_cvt
from noise_robust_vit_tpu_torch import CvT, convert_params, create_model
from noise_robust_vit_tpu_torch.models import cvt
from noise_robust_vit_tpu_torch.models.layers import Conv
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss
from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa

torch.set_num_threads(1)

CFG = dict(num_classes=5, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24, s2_heads=1,
           s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1)
LOGITS = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=5e-5, rtol=1e-4)


def _variables(jmodel, x, seed):
    """The JAX model's variables, every leaf perturbed from a numpy seed:
    parameters and means by N(0, 0.1²), variances drawn in [1, 1.5]."""
    rng = np.random.default_rng(seed)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "var":
            return (1.0 + 0.5 * rng.random(leaf.shape)).astype(np.float32)
        return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


# (image, the robust attention calls of one forward: streaming q shapes,
# rect logits shapes)
ROUTES = {32: ([], [(4, 1, 64, 16), (4, 1, 16, 4)]),
          112: ([(4, 1, 784, 64)], [(4, 1, 196, 49), (4, 2, 49, 16)])}


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("image", [32, 112])
def test_train_step_matches_jax(image, robust, monkeypatch):
    """Train mode: logits, every parameter gradient and the BN running
    statistics after one step, against JAX's ``mutable=["batch_stats"]``,
    and which attention path each stage took."""
    rng = np.random.default_rng(image)
    x = rng.standard_normal((4, image, image, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)
    jmodel = jax_cvt.CvT(robust=robust, **CFG)
    variables = _variables(jmodel, x, image + 1)
    model = CvT(robust=robust, device="cpu", **CFG)
    model.load_state_dict(convert_params(variables), strict=True)

    def loss_fn(params):
        logits, updates = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            deterministic=False, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return loss, (logits, updates)

    (_, (logits_j, updates)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    calls = []
    real_stream, real_rect = sa.StreamingAttention.apply, ss.SinkhornSoftmaxRect.apply
    monkeypatch.setattr(sa.StreamingAttention, "apply", lambda q, *a: (
        calls.append(("stream", tuple(q.shape))) or real_stream(q, *a)))
    monkeypatch.setattr(ss.SinkhornSoftmaxRect, "apply", lambda s, *a: (
        calls.append(("rect", tuple(s.shape))) or real_rect(s, *a)))
    for counts in (sa.launches, ss.launches, ss.launches_rect):
        counts.reset()
    model.train()
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t, torch.from_numpy(y)).backward()
    stream, rect = ROUTES[image]
    want = ([("stream", s) for s in stream] + [("rect", s) for s in rect]) if robust else []
    assert calls == want
    # CPU tensors: the plain versions, no kernel
    assert all((c.fwd, c.bwd) == (0, 0) for c in (sa.launches, ss.launches, ss.launches_rect))

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **LOGITS)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(), err_msg=name, **TOL)
    stats_j = convert_params({"params": {}, "batch_stats": jax.device_get(updates["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert stats_j.keys() == set(buffers)
    for name, v in stats_j.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), err_msg=name, **TOL)


def test_cvt_13_takes_the_jax_tree_strictly():
    """The full CvT-13 (on the meta device: nothing is allocated) takes the
    JAX model's variables strictly by name and shape, depthwise HWIO
    [3, 3, 1, C] kernels as OIHW [C, 1, 3, 3], and has its parameter count
    (the CvT paper gives 20 M)."""
    jmodel = jax_cvt.CvT(num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    state = convert_params(tree)
    assert state["s1_b0_attn.to_q.dw.weight"].shape == (64, 1, 3, 3)
    assert state["s3_b9_attn.to_kv.pw.weight"].shape == (768, 384, 1, 1)
    assert "s1_b0_attn.to_q.dw.bias" not in state
    assert state["s2_b1_attn.to_kv.bn.running_var"].shape == (192,)
    model = create_model("cvt_13", num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 19_936_296
    model.load_state_dict(state, strict=True, assign=True)


def test_depthwise_and_bias_free_conv():
    """``Conv(groups=C, use_bias=False)``: flax's depthwise conv with no
    bias leaf, and the same numbers as torch's grouped convolution."""
    conv = Conv(6, 6, 3, 2, 1, device="cpu", groups=6, use_bias=False)
    assert conv.bias is None and set(conv.state_dict()) == {"weight"}
    assert conv.weight.shape == (6, 1, 3, 3)
    x = torch.randn(2, 9, 9, 6)
    want = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, None, 2, 1, 1, 6).permute(0, 2, 3, 1)
    torch.testing.assert_close(conv(x), want)
    assert Conv(6, 8, 1, device="cpu").bias.shape == (8,)


def test_macs_per_image():
    """``cvt_macs_per_image``: CvT-13 at 224 px is 4.54 G multiply-adds (the
    paper gives 4.5 G), and torch's FLOP counter on the vanilla forward (on
    the meta device: convolutions, the attention products, the head) counts
    twice as many FLOPs."""
    full = create_model("cvt_13", num_classes=1000, device="meta")
    assert cvt.cvt_macs_per_image(full) == 4_543_682_816
    with FlopCounterMode(display=False) as counter:
        full(torch.empty(1, 224, 224, 3, device="meta"))
    assert counter.get_total_flops() == 2 * cvt.cvt_macs_per_image(full)
    small = CvT(device="meta", **CFG)
    with FlopCounterMode(display=False) as counter:
        small(torch.empty(1, 112, 112, 3, device="meta"))
    assert counter.get_total_flops() == 2 * cvt.cvt_macs_per_image(small, 112)


def test_cvt_13_config_is_the_jax_factory_s():
    """dims 64/192/384, heads 1/3/6, depths 1/2/10, kv stride 2, dim_head
    64; ``image_size`` does not change the model, as in JAX."""
    model = create_model("cvt_13", num_classes=10, image_size=112, device="meta")
    assert [model.stages[s]["emb_dim"] for s in (1, 2, 3)] == [64, 192, 384]
    assert [model.stages[s]["heads"] for s in (1, 2, 3)] == [1, 3, 6]
    assert [model.stages[s]["depth"] for s in (1, 2, 3)] == [1, 2, 10]
    assert model.s3_b0_attn.to_q.pw.weight.shape == (6 * 64, 384, 1, 1)
    with pytest.raises(TypeError, match="unknown CvT arguments"):
        CvT(num_classes=10, device="meta", s4_depth=1)


def test_builders_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("cvt_13", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CvT(num_classes=10, robust=True)


def test_sinkhorn_schedule_attributes_are_what_both_paths_run(monkeypatch):
    """``_CvtAttention.sinkhorn_iters`` and ``final_row_norm`` (the schedule
    the benchmark's set-up reads) are what the streaming call is given and
    what ``robust_softmax`` passes to the rect kernels: at 112 px stage 1
    streams, stages 2 and 3 take the rect path."""
    calls = []
    real_stream, real_rect = sa.StreamingAttention.apply, ss.SinkhornSoftmaxRect.apply
    monkeypatch.setattr(sa.StreamingAttention, "apply", lambda q, k, v, scale, it, fin: (
        calls.append(("stream", it, fin)) or real_stream(q, k, v, scale, it, fin)))
    monkeypatch.setattr(ss.SinkhornSoftmaxRect, "apply", lambda s, it, fin: (
        calls.append(("rect", it, fin)) or real_rect(s, it, fin)))
    model = CvT(robust=True, device="cpu", **CFG)
    attns = [m for m in model.modules() if isinstance(m, cvt._CvtAttention)]
    assert len(attns) == 3
    assert {(m.sinkhorn_iters, m.final_row_norm) for m in attns} == {(3, True)}
    model.train()
    model(torch.randn(2, 112, 112, 3)).sum().backward()
    assert calls == [("stream", 3, True), ("rect", 3, True), ("rect", 3, True)]
