"""The port's torchvision-style VisionTransformer against the JAX package, on
the CPU in float32.

A small JAX ``VisionTransformer`` (32 px, patch 8, 2 layers, 2 heads of 32,
MLP 128) is initialized, every parameter (and batch statistic) is perturbed
from a numpy seed so that the zero-init head and class token pass gradients
on, and the variables are carried across with ``convert_params``. Logits and
every parameter gradient of the mean cross-entropy are compared at 5e-5,
robust and vanilla: robust attention takes the port's plain packed version on
the 4-iteration schedule with no final row norm, and JAX its vector form on
the same schedule (off the TPU JAX takes no Pallas kernel). The conv stem is
compared in train mode, with the BN running statistics after the step; the
representation head, ``return_features``, the refusal of dropout,
``interpolate_embeddings`` against JAX's (1e-5) and the published widths of
``vit_b_16`` complete the slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from noise_robust_vit_tpu.models import vision_transformer as jax_vt
from noise_robust_vit_tpu_torch import VisionTransformer, convert_params, create_model
from noise_robust_vit_tpu_torch.models import vision_transformer as vt
from noise_robust_vit_tpu_torch.ops.cuda import fused_ln as fl
from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa
from noise_robust_vit_tpu_torch.ops.norms import FusedLayerNorm
from noise_robust_vit_tpu_torch.train import create_train_state

torch.set_num_threads(1)

CFG = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=64,
           mlp_dim=128, num_classes=10)
TOL = dict(atol=5e-5, rtol=5e-5)
# three stride-2 stages take 32 px to the 4 × 4 grid of patch 8; a 3×3
# stride-2 SAME conv over an even side pads only after
STEM = [(16, 3, 2), (24, 3, 2), (32, 3, 2)]


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


def _compare(kwargs, robust, train, seed, monkeypatch):
    """Logits, every gradient and (train mode) the updated batch statistics
    of one step, port against JAX; returns the packed calls' schedules."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)
    stem = kwargs.get("conv_stem_configs")
    jkw = dict(kwargs, conv_stem_configs=None if stem is None else
               [jax_vt.ConvStemConfig(*c) for c in stem])
    jmodel = jax_vt.VisionTransformer(robust=robust, **jkw)
    variables = _variables(jmodel, x, seed)
    tkw = dict(kwargs, conv_stem_configs=None if stem is None else
               [vt.ConvStemConfig(*c) for c in stem])
    model = VisionTransformer(robust=robust, device="cpu", **tkw)
    model.load_state_dict(convert_params(variables), strict=True)
    has_stats = "batch_stats" in variables

    def loss_fn(params):
        v = dict(variables, params=params)
        if has_stats:
            logits, updates = jmodel.apply(v, jnp.asarray(x), deterministic=not train,
                                           mutable=["batch_stats"])
        else:
            logits, updates = jmodel.apply(v, jnp.asarray(x), deterministic=not train), {}
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return loss, (logits, updates)

    (_, (logits_j, updates)), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])

    schedules = []
    real = pa.PackedAttention.apply
    monkeypatch.setattr(pa.PackedAttention, "apply",
                        lambda qkv, *a: schedules.append(a[3:]) or real(qkv, *a))
    model.train(train)
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t, torch.from_numpy(y)).backward()

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(), err_msg=name, **TOL)
    if has_stats:
        stats_j = convert_params({"params": {}, "batch_stats":
                                  jax.device_get(updates["batch_stats"])})
        buffers = dict(model.named_buffers())
        assert stats_j.keys() == set(buffers)
        for name, v in stats_j.items():
            np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), err_msg=name, **TOL)
    return schedules


@pytest.mark.parametrize("robust", [False, True])
def test_logits_and_grads_match_jax(robust, monkeypatch):
    """Patch stem, eval mode: both layers' attention takes the packed path
    on (robust, 4 iterations, no final row norm)."""
    schedules = _compare(CFG, robust, False, 0, monkeypatch)
    assert schedules == [(robust, 4, False)] * 2


@pytest.mark.parametrize("robust", [False, True])
def test_conv_stem_train_mode_matches_jax(robust, monkeypatch):
    """The conv-BN-ReLU stem in train mode: logits, grads and the BN
    running statistics after the step."""
    _compare(dict(CFG, conv_stem_configs=STEM), robust, True, 1, monkeypatch)


def test_representation_head_matches_jax(monkeypatch):
    _compare(dict(CFG, representation_size=48), True, False, 2, monkeypatch)


def test_return_features_matches_jax():
    """``return_features``: the class token's features after the final LN."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmodel = jax_vt.VisionTransformer(robust=True, **CFG)
    variables = _variables(jmodel, x, 3)
    want = jmodel.apply(variables, jnp.asarray(x), return_features=True)
    model = VisionTransformer(robust=True, device="cpu", **CFG)
    model.load_state_dict(convert_params(variables), strict=True)
    got = model(torch.from_numpy(x), return_features=True)
    assert got.shape == (2, CFG["hidden_dim"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("field", ["dropout", "attention_dropout"])
def test_dropout_is_refused(field):
    with pytest.raises(NotImplementedError, match="attention-weights path"):
        VisionTransformer(device="cpu", **CFG, **{field: 0.1})


def test_image_size_is_checked():
    model = VisionTransformer(device="cpu", **CFG)
    with pytest.raises(ValueError, match="expected 32px"):
        model(torch.zeros(1, 40, 40, 3))


@pytest.mark.parametrize("new_size", [48, 16], ids=["up_4_to_6", "down_4_to_2"])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_interpolate_embeddings_matches_jax(new_size, mode):
    """The position embedding of a 4 × 4 grid (patch 8 at 32 px) resized to
    6 × 6 and, antialiased, to 2 × 2, as jax.image.resize does it (1e-5);
    every other entry is passed through."""
    rng = np.random.default_rng(4)
    pos = rng.standard_normal((1, 17, 64)).astype(np.float32)
    other = rng.standard_normal((64,)).astype(np.float32)
    want = jax_vt.interpolate_embeddings(
        {"encoder": {"pos_embedding": jnp.asarray(pos), "ln": {"bias": jnp.asarray(other)}}},
        new_size, 8, interpolation_mode=mode)
    state = {"encoder.pos_embedding": torch.from_numpy(pos),
             "encoder.ln.bias": torch.from_numpy(other)}
    got = vt.interpolate_embeddings(state, new_size, 8, interpolation_mode=mode)
    side = new_size // 8
    assert got["encoder.pos_embedding"].shape == (1, side * side + 1, 64)
    np.testing.assert_allclose(got["encoder.pos_embedding"].numpy(),
                               np.asarray(want["encoder"]["pos_embedding"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["encoder.ln.bias"].numpy(), other)


def test_interpolated_model_runs_at_the_new_size():
    """A model built for 48 px takes the resized state strictly."""
    model = VisionTransformer(device="cpu", **CFG)
    state = vt.interpolate_embeddings(model.state_dict(), 48, 8)
    bigger = VisionTransformer(device="cpu", **dict(CFG, image_size=48))
    bigger.load_state_dict(state, strict=True)
    assert bigger(torch.zeros(2, 48, 48, 3)).shape == (2, 10)


@pytest.mark.parametrize("name,patch,layers,heads,hidden,mlp,n_params", [
    ("vit_b_16", 16, 12, 12, 768, 3072, 86_567_656),
    ("vit_b_32", 32, 12, 12, 768, 3072, 88_224_232),
    ("vit_l_16", 16, 24, 16, 1024, 4096, 304_326_632),
    ("vit_h_14", 14, 32, 16, 1280, 5120, 632_045_800),
])
def test_builders_take_the_published_widths(name, patch, layers, heads, hidden, mlp, n_params):
    """The builders at full width and depth on the meta device (nothing is
    allocated): torchvision's parameter counts at 1000 classes, and the
    JAX tree of the same builder taken strictly by name and shape."""
    model = create_model(name, num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert model.encoder.pos_embedding.shape == (1, (224 // patch) ** 2 + 1, hidden)
    attn = getattr(model.encoder, f"layer_{layers - 1}").self_attention
    assert (attn.heads, attn.dim_head, attn.sinkhorn_iters, attn.final_row_norm) == (
        heads, hidden // heads, 4, False)
    assert attn.norm is None and attn.to_qkv.bias.shape == (3 * hidden,)
    assert getattr(model.encoder, f"layer_{layers - 1}").mlp.fc1.weight.shape == (mlp, hidden)
    if name == "vit_b_16":
        jmodel = jax_vt.vit_b_16(num_classes=1000)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        model.load_state_dict(convert_params(tree), strict=True, assign=True)


def test_vit_b_16_is_off_the_fused_ln_switch():
    """vit_b_16's norms stay plain at D 768: every LayerNorm of the model is
    the plain one (eps 1e-6), though 768 is inside the fused kernels' gate;
    the model builds its own norms, as in JAX."""
    model = create_model("vit_b_16", num_classes=1000, device="meta")
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 12 + 1 and all(m.eps == 1e-6 for m in norms)
    assert not any(isinstance(m, FusedLayerNorm) for m in model.modules())


def test_train_step_runs_on_cpu_without_kernel_launches():
    """One AdamW step of the small robust model on CPU tensors: a finite
    loss, and the plain versions serve it (no kernel launch is counted)."""
    model = VisionTransformer(robust=True, device="cpu", **CFG)
    state = create_train_state(model)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    pa.launches.reset()
    fl.launches.reset()
    loss = state.train_step(x, y)
    assert torch.isfinite(loss)
    assert (pa.launches.fwd, pa.launches.bwd, fl.launches.fwd, fl.launches.bwd) == (0, 0, 0, 0)
