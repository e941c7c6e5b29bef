"""The port's MobileViT slice against the JAX package, on the CPU in float32.

A small JAX ``MobileViT`` (dims 16/24/16, channels (8, 8, 12, 16, 16, 24,
24, 24, 24, 32, 48), depth 1 a stage, 4 heads of 8) is initialized, every
parameter and batch statistic is perturbed from a numpy seed, and the
variables are carried across with ``convert_params`` (params and
``batch_stats``). ch[2] ≠ ch[3] and ch[4 + 2i] ≠ ch[5 + 2i], so stem3's
quirk (built as ch[2] → ch[3], fed ch[3] channels) and the MobileViT
blocks' input widths are exercised. Train mode compares the logits, every
parameter gradient of the mean cross-entropy and the updated
``batch_stats``, robust and vanilla, at 64 px (transformer sequences of 16,
4 and 1 tokens) and 128 px (64, 16 and 4): robust attention takes the
port's plain fused q/k/v version and JAX its vector form (off the TPU JAX
takes no Pallas kernel). Tolerance 1e-4 (atol and rtol), LeViT's: BatchNorm
over four images divides by batch standard deviations and amplifies the
float32 rounding of sums that run in another order in the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from torch.utils.flop_counter import FlopCounterMode

from noise_robust_vit_tpu.models import mobile_vit as jax_mvit
from noise_robust_vit_tpu_torch import MobileViT, convert_params, create_model
from noise_robust_vit_tpu_torch import ops
from noise_robust_vit_tpu_torch.models import mobile_vit
from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa

torch.set_num_threads(1)

CFG = dict(num_classes=5, dims=(16, 24, 16), channels=(8, 8, 12, 16, 16, 24, 24, 24, 24, 32, 48),
           depths=(1, 1, 1))
TOL = dict(atol=1e-4, rtol=1e-4)


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


# image → the q shapes of the robust attention calls of one forward (4
# images × 4 patch positions, 4 heads of 8)
ROUTES = {64: [(16, 4, 16, 8), (16, 4, 4, 8), (16, 4, 1, 8)],
          128: [(16, 4, 64, 8), (16, 4, 16, 8), (16, 4, 4, 8)]}


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("image", [64, 128])
def test_train_step_matches_jax(image, robust, monkeypatch):
    """Train mode: logits, every parameter gradient and the BN running
    statistics after one step, against JAX's ``mutable=["batch_stats"]``,
    and which attention path each transformer took."""
    rng = np.random.default_rng(image)
    x = rng.standard_normal((4, image, image, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)
    jmodel = jax_mvit.MobileViT(image_size=(image, image), robust=robust, **CFG)
    variables = _variables(jmodel, x, image + int(robust))
    model = MobileViT(robust=robust, device="cpu", **CFG)
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
    real = fa.FusedAttention.apply
    monkeypatch.setattr(fa.FusedAttention, "apply",
                        lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a))
    fa.launches.reset()
    model.train()
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t, torch.from_numpy(y)).backward()
    assert calls == (ROUTES[image] if robust else [])
    assert (fa.launches.fwd, fa.launches.bwd) == (0, 0)  # CPU tensors: the plain version

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)
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


def test_mobile_vit_xs_takes_the_jax_tree_strictly():
    """The full MobileViT-XS (on the meta device: nothing is allocated)
    takes the JAX model's variables strictly by name and shape, depthwise
    HWIO [3, 3, 1, C] kernels as OIHW [C, 1, 3, 3], with 2,382,944
    parameters and 9,168 BatchNorm statistics at 1000 classes."""
    jmodel = jax_mvit.MobileViT(image_size=(256, 256), dims=(96, 120, 144),
                                channels=(16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384),
                                num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_stats = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    state = convert_params(tree)
    assert state["stem1.dw.weight"].shape == (128, 1, 3, 3)
    assert state["trunk2_mvit.transformer.layers_2_attn.to_out.bias"].shape == (144,)
    assert state["trunk1_mvit.conv4.conv.weight"].shape == (80, 160, 3, 3)
    assert state["stem3.pw.weight"].shape == (192, 48, 1, 1)
    assert "head.bias" not in state
    model = create_model("mobile_vit_xs", num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 2_382_944
    assert sum(b.numel() for b in model.buffers()) == n_stats == 9_168
    model.load_state_dict(state, strict=True, assign=True)


def test_macs_per_image():
    """``mobile_vit_macs_per_image``: MobileViT-XS at 256 px is 0.9155 G
    multiply-adds, and torch's FLOP counter on the vanilla forward (on the
    meta device: the convolutions, the Dense layers, q·kᵀ and attn·v, the
    head) counts twice as many FLOPs; likewise the small config at 128 px."""
    full = create_model("mobile_vit_xs", num_classes=1000, device="meta")
    assert mobile_vit.mobile_vit_macs_per_image(full) == 915_516_416
    with FlopCounterMode(display=False) as counter:
        full(torch.empty(1, 256, 256, 3, device="meta"))
    assert counter.get_total_flops() == 2 * mobile_vit.mobile_vit_macs_per_image(full)
    small = MobileViT(device="meta", **CFG)
    with FlopCounterMode(display=False) as counter:
        small(torch.empty(1, 128, 128, 3, device="meta"))
    assert counter.get_total_flops() == 2 * mobile_vit.mobile_vit_macs_per_image(small, 128)


def test_mobile_vit_xs_config_is_the_jax_factory_s():
    """dims 96/120/144, depths 2/4/3, 4 heads of 8 with a to_out bias, MLP
    dims × (2, 4, 4), and stem3 built as ch[2] → ch[3] (the reference's
    quirk: its residual follows ch[2] == ch[3])."""
    model = create_model("mobile_vit_xs", num_classes=10, device="meta")
    tfs = [getattr(model, f"trunk{i}_mvit").transformer for i in range(3)]
    assert [tf.depth for tf in tfs] == [2, 4, 3]
    attn = tfs[0].layers_0_attn
    assert (attn.heads, attn.dim_head, attn.to_out.bias is not None) == (4, 8, True)
    assert [tf.layers_0_ff.fc1.out_features for tf in tfs] == [192, 480, 576]
    assert tfs[2].layers_0_ff.act is ops.silu
    assert model.stem3.use_res and model.stem3.pw.weight.shape == (192, 48, 1, 1)
    small = MobileViT(device="meta", **CFG)
    assert not small.stem3.use_res and small.stem3.pw.weight.shape == (48, 16, 1, 1)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_silu_matches_jax(dtype):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = np.asarray(nn.silu(jnp.asarray(x, dtype)), np.float32)
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = ops.silu(torch.from_numpy(x).to(tdtype)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype is np.float32 else 1e-2,
                               rtol=1e-6 if dtype is np.float32 else 8e-3)


def test_builders_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("mobile_vit_xs", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MobileViT(robust=True, **CFG)
