"""The port's CaiT slice against the JAX package, on the CPU in float32.

A small JAX ``CaiT`` (image 32, patch 8, dim 64, depth 2, cls_depth 1,
4 heads, MLP 128) is initialized from a seed and its parameters are carried
across with ``convert_params``. The logits and every parameter gradient of
the mean cross-entropy are compared, robust and vanilla, at the JAX suite's
tolerances (``tests/test_talking_heads.py``): logits atol and rtol 1e-5,
gradients rtol 5e-5 with an atol of 5e-5 of each tensor's largest
magnitude. The CLS stage attends with one query row, whose Sinkhorn is
nearly uniform, so the gradients of its ``to_q`` and ``to_kv`` are tiny;
an absolute atol would not compare them.

Robust models run the talking-heads sandwich on the patch stage's square
logits [4, 4, 16, 16] (the port's plain version here; JAX its unfused
einsum path, which it takes off the TPU) and the vector form on the CLS
stage's [4, 4, 1, 17].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from noise_robust_vit_tpu.models import cait as jax_cait
from noise_robust_vit_tpu_torch import CaiT, convert_params, create_model
from noise_robust_vit_tpu_torch.models.cait import cait_macs_per_image
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss
from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th

torch.set_num_threads(1)

CFG = dict(image_size=32, patch_size=8, num_classes=5, dim=64, depth=2, cls_depth=1, heads=4,
           mlp_dim=128)
LOGITS = dict(atol=1e-5, rtol=1e-5)


def _pair(robust, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)
    jmodel = jax_cait.CaiT(robust=robust, **CFG)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x)))["params"]
    model = CaiT(robust=robust, device="cpu", **CFG)
    model.load_state_dict(convert_params(params), strict=True)
    return jmodel, params, model, x, y


@pytest.mark.parametrize("robust", [False, True])
def test_logits_and_gradients_match_jax(robust, monkeypatch):
    jmodel, params, model, x, y = _pair(robust)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return loss, logits

    (_, logits_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    calls = []
    real = th.TalkingHeadsSinkhorn.apply
    monkeypatch.setattr(th.TalkingHeadsSinkhorn, "apply", lambda d, *a: (
        calls.append(tuple(d.shape)) or real(d, *a)))
    for counts in (th.launches, ss.launches, ss.launches_rect):
        counts.reset()
    model.train()
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t, torch.from_numpy(y)).backward()
    # the patch stage's square logits take the fused sandwich (its plain
    # version on CPU tensors: no kernel), the CLS stage's one row does not
    assert calls == ([(4, 4, 16, 16)] * 2 if robust else [])
    assert all((c.fwd, c.bwd) == (0, 0) for c in (th.launches, ss.launches, ss.launches_rect))

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **LOGITS)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        g = g.numpy()
        np.testing.assert_allclose(grads_t[name].numpy(), g, rtol=5e-5,
                                   atol=5e-5 * np.abs(g).max(), err_msg=name)


def test_parameter_names_and_count_match_jax_at_full_width():
    """The full-width ``cait`` @224 (on the meta device: nothing is
    allocated) takes the JAX model's tree strictly by name and shape, and
    has its parameter count."""
    jmodel = jax_cait.CaiT(image_size=224, patch_size=16, num_classes=1000, dim=512, depth=6,
                           cls_depth=2, heads=8, mlp_dim=1024)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    model = create_model("cait", num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 17_827_816
    model.load_state_dict(convert_params(tree), strict=True, assign=True)


def test_layerscale_and_mix_init():
    """LayerScale starts at 0.1 for depth ≤ 18 (1e-5 to 24, 1e-6 beyond);
    the mixes, the position embedding and the CLS token are N(0, 1)."""
    model = create_model("cait", num_classes=10, image_size=32, device="cpu", depth=20,
                         cls_depth=1, dim=32, heads=2, mlp_dim=32)
    stage = model.patch_transformer.requires_grad_(False)
    assert torch.all(stage.scale_attn_0 == 0.1) and torch.all(stage.scale_ff_17 == 0.1)
    assert torch.all(stage.scale_attn_18 == 1e-5) and torch.all(stage.scale_ff_19 == 1e-5)
    assert 0.7 < model.pos_embedding.detach().std().item() < 1.3
    assert stage.attn_0.to_q.bias is None and stage.attn_0.to_kv.bias is None


def test_train_mode_dropout_draws_from_its_generator():
    """With ``layer_dropout`` and ``dropout`` a train-mode forward runs, and
    the whole-layer draws come from the generator ``create_model`` seeds;
    at ``layer_dropout=1`` every layer is dropped, so the logits no longer
    depend on the image."""
    kw = dict(num_classes=5, image_size=32, device="cpu", depth=2, cls_depth=1, dim=32,
              heads=2, mlp_dim=32, robust=True)
    model = create_model("cait", layer_dropout=0.2, dropout=0.1, **kw)
    gen = model.patch_transformer.generator
    assert gen is not None and gen is model.cls_transformer.generator
    before = gen.get_state().clone()
    model.train()
    out = model(torch.randn(2, 32, 32, 3))
    assert out.shape == (2, 5) and torch.isfinite(out).all()
    assert not torch.equal(before, gen.get_state())
    model.eval()  # eval mode: no draws
    before = gen.get_state().clone()
    model(torch.randn(2, 32, 32, 3))
    assert torch.equal(before, gen.get_state())

    dropped = create_model("cait", layer_dropout=1.0, **kw).train()
    x = torch.randn(2, 32, 32, 3)
    a, b = dropped(x), dropped(x.flip(0) + 1.0)
    torch.testing.assert_close(a, b)


def test_macs_per_image():
    """``cait_macs_per_image``: the hand count of the full model (≈ 2.99 G
    multiply-adds), and torch's FLOP counter on the vanilla forward (on the
    meta device), less the head mixes, which it counts and the MFU does
    not."""
    full = create_model("cait", num_classes=1000, device="meta")
    n, d, inner, mlp, h = 196, 512, 512, 1024, 8
    patch_layer = n * d * 3 * inner + 2 * h * n * n * 64 + n * inner * d + 2 * n * d * mlp
    cls_layer = d * inner + (n + 1) * d * 2 * inner + 2 * h * (n + 1) * 64 + inner * d + 2 * d * mlp
    assert cait_macs_per_image(full) == (n * 768 * d + 6 * patch_layer + 2 * cls_layer
                                         + d * 1000) == 2_989_979_648

    with FlopCounterMode(display=False) as counter:
        full(torch.empty(1, 224, 224, 3, device="meta"))
    mixes = 2 * h * h * (6 * n * n + 2 * (n + 1))
    assert counter.get_total_flops() == 2 * (cait_macs_per_image(full) + mixes)


def test_builders_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("cait", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CaiT(robust=True, **CFG)
