"""The port's LeViT slice against the JAX package, on the CPU in float32.

A small JAX ``LeViT`` (image 112, embed (32, 48, 64), key dim 16, heads
(2, 3, 4), depth (1, 1, 1), the subsample ops ``_factory`` builds) is
initialized, every parameter and batch statistic is perturbed from a numpy
seed (the init's zero BN scales would zero whole branches and their
gradients), and the variables are carried across with ``convert_params``.
Train mode compares logits, every parameter gradient of the mean
cross-entropy and the updated ``batch_stats``; eval mode compares logits,
and logits after the BN fusion. Tolerance 1e-4 (atol and rtol): BatchNorm
over a batch of four images divides by batch standard deviations and
amplifies the float32 rounding of the sums, which run in another order in
the two packages. Robust models run the biased attention at N = 49, 16
and 4 and the rectangular Sinkhorn softmax at [4, 2, 16, 49] and
[4, 3, 4, 16] (their plain versions here; JAX runs its Pallas kernels in
interpret mode); vanilla models a softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from noise_robust_vit_tpu import ops as jax_ops
from noise_robust_vit_tpu.models import levit as jax_levit
from noise_robust_vit_tpu.ops.pallas.biased_attention import (
    biased_attention_supported as jax_biased_supported,
)
from noise_robust_vit_tpu_torch import LeViT, convert_params, create_model
from noise_robust_vit_tpu_torch.models import levit
from noise_robust_vit_tpu_torch.models.layers import BatchNorm
from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss

torch.set_num_threads(1)

D = 16
EMBED = (32, 48, 64)
CFG = dict(img_size=112, patch_size=16, num_classes=5, embed_dim=EMBED, key_dim=(D,) * 3,
           depth=(1, 1, 1), num_heads=(2, 3, 4), attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
           down_ops=(("Subsample", D, EMBED[0] // D, 4, 2, 2),
                     ("Subsample", D, EMBED[1] // D, 4, 2, 2)))
TOL = dict(atol=1e-4, rtol=1e-4)


def _variables(jmodel, x, seed):
    """The JAX model's variables, every leaf perturbed from a numpy seed:
    parameters by N(0, 0.1²), means by N(0, 0.1²), variances drawn in
    [1, 1.5]."""
    rng = np.random.default_rng(seed)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "var":
            return (1.0 + 0.5 * rng.random(leaf.shape)).astype(np.float32)
        return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _pair(robust, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 112, 112, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)
    jmodel = jax_levit.LeViT(robust=robust, **CFG)
    variables = _variables(jmodel, x, seed + 1)
    model = LeViT(robust=robust, device="cpu", **CFG)
    model.load_state_dict(convert_params(variables), strict=True)
    return jmodel, variables, model, x, y


def _jax_apply(jmodel, variables, x):
    """Eval-mode logits, jitted (XLA compiles the graph once instead of
    every op on its own)."""
    try:
        jax_ops.set_use_pallas(True)
        return jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    finally:
        jax_ops.set_use_pallas(None)


@pytest.mark.parametrize("robust", [False, True])
def test_train_step_matches_jax(robust):
    """Train mode: logits, every parameter gradient and the BN running
    statistics after one step, against JAX's ``mutable=["batch_stats"]``."""
    jmodel, variables, model, x, y = _pair(robust)

    def loss_fn(params):
        logits, updates = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            deterministic=False, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(y)).mean()
        return loss, (logits, updates)

    try:
        jax_ops.set_use_pallas(True)
        (_, (logits_j, updates)), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    finally:
        jax_ops.set_use_pallas(None)

    model.train()
    ba.launches.reset()
    ss.launches_rect.reset()
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t.float(), torch.from_numpy(y)).backward()
    # CPU tensors: the plain versions, no kernel
    assert (ba.launches.fwd, ss.launches_rect.fwd, ss.launches_rect.bwd) == (0, 0, 0)

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(), err_msg=name, **TOL)
    stats_j = convert_params({"params": {}, "batch_stats": jax.device_get(
        updates["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert stats_j.keys() == {k for k in buffers if k.endswith(("running_mean", "running_var"))}
    for name, v in stats_j.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("robust", [False, True])
def test_eval_logits_and_fusion_match_jax(robust):
    """Eval mode (running statistics), then both packages' BN fusion: the
    fused weights, loaded into the same models, give the same logits."""
    jmodel, variables, model, x, _ = _pair(robust, seed=3)
    model.eval()
    want = np.asarray(_jax_apply(jmodel, variables, x))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, **TOL)
        fused_j = jax_levit.fuse_levit_variables(variables)
        fused_t = levit.fuse_levit_variables(model)
        for name, v in convert_params(jax.device_get(fused_j)).items():
            np.testing.assert_allclose(fused_t[name].numpy(), v.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=name)
        model.load_state_dict(fused_t, strict=True)
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_apply(jmodel, fused_j, x)), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_robust_levit_routes_to_the_kernels(monkeypatch):
    """Robust: every square attention takes the biased attention and both
    subsamples the rectangular Sinkhorn softmax; vanilla takes neither."""
    calls = []
    real_biased, real_rect = levit.ops.biased_attention, ss.SinkhornSoftmaxRect.apply

    def spy_biased(q, k, v, bias, **kw):
        calls.append(("biased", tuple(q.shape), tuple(v.shape[-1:])))
        return real_biased(q, k, v, bias, **kw)

    def spy_rect(logits, *args):
        calls.append(("rect", tuple(logits.shape)))
        return real_rect(logits, *args)

    monkeypatch.setattr(levit.ops, "biased_attention", spy_biased)
    monkeypatch.setattr(ss.SinkhornSoftmaxRect, "apply", spy_rect)
    x = torch.zeros(2, 112, 112, 3)
    LeViT(robust=False, device="cpu", **CFG)(x)
    assert calls == []
    LeViT(robust=True, device="cpu", **CFG)(x)
    assert calls == [("biased", (2, 2, 49, 16), (32,)), ("rect", (2, 2, 16, 49)),
                     ("biased", (2, 3, 16, 16), (32,)), ("rect", (2, 3, 4, 16)),
                     ("biased", (2, 4, 4, 16), (32,))]


def test_stage0_at_dv_64_takes_the_biased_kernel(monkeypatch):
    """LeViT-192/256/384's stage 0 (key dim 32, so DV = 64 at N = 196) is
    inside the biased kernels' gate, as it is inside the JAX package's: that
    attention runs ``biased_attention``, and no square logits reach
    ``SinkhornSoftmax``."""
    calls = []
    real_biased, real_square = levit.ops.biased_attention, ss.SinkhornSoftmax.apply
    monkeypatch.setattr(levit.ops, "biased_attention", lambda q, k, v, bias, **kw: (
        calls.append(("biased", tuple(q.shape), v.shape[-1])) or real_biased(q, k, v, bias, **kw)))
    monkeypatch.setattr(ss.SinkhornSoftmax, "apply", lambda logits, *a: (
        calls.append(("square", tuple(logits.shape))) or real_square(logits, *a)))
    attn = levit.LevitAttention(64, 32, 2, 2, 14, robust=True)
    assert ba.biased_attention_supported(1, 2, 196, 32, 64, 1)
    assert jax_biased_supported(1, 2, 196, 32, 64, 1)
    attn(torch.randn(1, 196, 64))
    assert calls == [("biased", (1, 2, 196, 32), 64)]


def test_batch_norm_is_flax_batch_norm():
    """Biased variance, 0.99/0.01 running averages, statistics in float32
    for a bfloat16 input, no num_batches_tracked."""
    bn = BatchNorm(3, dtype=torch.bfloat16)
    x = torch.randn(6, 5, 3) * 2 + 1
    y = bn.train()(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    xb = x.to(torch.bfloat16).float()
    mean, var = xb.mean((0, 1)), xb.var((0, 1), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var, atol=1e-6, rtol=1e-5)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean", "running_var"}


@pytest.mark.parametrize("name", ["LeViT_128S", "LeViT_256"])
def test_full_width_parameter_count_matches_jax(name):
    """Full width at 1000 classes, on the meta device (nothing allocated),
    against ``jax.eval_shape`` of the JAX builder's init."""
    jmodel = getattr(jax_levit, name)(num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = create_model(name, num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want


def test_attention_flops_match_jax():
    """``levit_flops`` (the reference's attention FLOP counter) of the
    port's LeViT-128S and LeViT-256 against the JAX package's."""
    for name in ("LeViT_128S", "LeViT_256"):
        model = create_model(name, num_classes=1000, device="meta")
        assert levit.levit_flops(model) == jax_levit.levit_flops(
            getattr(jax_levit, name)(num_classes=1000))


def test_levit_128s_jax_variables_load_strictly():
    """The weight bridge maps LeViT-128S's JAX variables (shapes only;
    zeros), params and batch_stats, onto the port's state_dict with strict
    loading: HWIO stem kernels, Dense kernels, BN scales and statistics, and
    the attention-bias tables."""
    jmodel = jax_levit.LeViT_128S(num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = convert_params(tree)
    assert state["stem0.c.weight"].shape == (16, 3, 3, 3)
    assert state["block0_attn.attention_biases"].shape == (4, 196)
    assert state["downsample0.attention_biases"].shape == (8, 196)
    assert state["head_bn.running_var"].shape == (384,)
    model = create_model("LeViT_128S", num_classes=1000, device="cpu")
    model.load_state_dict(state, strict=True)


def test_macs_per_image_match_the_flop_counter():
    """``levit_macs_per_image`` against torch's FLOP counter over one
    LeViT-128S image on the meta device (convolutions, linears and the two
    attention products; 2 FLOPs a multiply-add), and beside the 305 M the
    LeViT paper publishes."""
    model = create_model("levit", num_classes=1000, device="meta")
    with FlopCounterMode(display=False) as counter:
        model(torch.empty(1, 224, 224, 3, device="meta"))
    macs = levit.levit_macs_per_image(model)
    assert counter.get_total_flops() == 2 * macs
    assert abs(macs - 305e6) / 305e6 < 0.01


def test_entry_points_build_on_the_card_by_default():
    """No device named: the model is built on the card, or the call raises
    where there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert next(create_model("levit", num_classes=10).parameters()).is_cuda
        assert next(levit.LeViT_256(num_classes=10).parameters()).is_cuda
        assert next(LeViT(**CFG).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("levit", num_classes=10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            levit.LeViT_256(num_classes=10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LeViT(**CFG)
    model = create_model("levit", num_classes=10, device="cpu")
    assert isinstance(model, LeViT) and model.embed_dim == (128, 256, 384)
    assert next(model.parameters()).device.type == "cpu"
