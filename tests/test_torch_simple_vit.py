"""The port's SimpleViT slice against the JAX package, on the CPU in float32.

A small JAX ``SimpleViT`` is initialized, its parameters are carried across
with ``convert_params``, and logits and every parameter gradient of the
mean cross-entropy are compared (1e-5 and 5e-5). dim_head 32 is inside the
packed kernels' gate, so the port runs the packed path with its
hand-derived backward; dim_head 16 is outside it and takes the plain q/k/v
path. The optimizer is checked on its own against optax on the same
parameters and gradients.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from noise_robust_vit_tpu import SimpleViT as JaxSimpleViT
from noise_robust_vit_tpu.ops import gelu as jax_gelu
from noise_robust_vit_tpu.ops import posemb_sincos_2d as jax_posemb
from noise_robust_vit_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from noise_robust_vit_tpu.ops.sinkhorn import sinkhorn_scalings as jax_scalings
from noise_robust_vit_tpu_torch import SimpleViT, convert_params, create_model
from noise_robust_vit_tpu_torch.ops import (
    dot_product_attention,
    gelu,
    posemb_sincos_2d,
    sinkhorn_scalings,
)
from noise_robust_vit_tpu_torch.train import adamw, create_train_state

torch.set_num_threads(1)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
           heads=2, mlp_dim=128)


@pytest.mark.parametrize("dim_head", [32, 16], ids=["packed", "plain_qkv"])
@pytest.mark.parametrize("robust", [False, True])
def test_logits_and_grads_match_jax(robust, dim_head):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=4)

    jmodel = JaxSimpleViT(robust=robust, dim_head=dim_head, **CFG)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(y)).mean(), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)

    model = SimpleViT(robust=robust, dim_head=dim_head, device="cpu", **CFG)
    model.load_state_dict(convert_params(params), strict=True)
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t.float(), torch.from_numpy(y)).backward()

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(),
                                   atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax(steps):
    """Same parameters, same gradients: the port's AdamW lands where
    ``optax.adamw(1e-3, weight_decay=0.05)`` does."""
    rng = np.random.default_rng(1)
    shapes = {"w": (7, 5), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]

    tx = optax.adamw(1e-3, weight_decay=0.05)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)

    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = adamw(pt.values(), lr=1e-3, weight_decay=0.05)
    for g in grads:
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   atol=1e-6, rtol=0)


def test_train_step_runs():
    model = create_model("simple_vit", num_classes=10, image_size=32, robust=True,
                         dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32,
                         device="cpu")
    state = create_train_state(model)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    before = [p.detach().clone() for p in model.parameters()]
    loss = state.train_step(x, y)
    assert torch.isfinite(loss) and loss.ndim == 0
    assert state.step == 1
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_simple_vit_b16_builds_full_width_on_meta():
    """The flagship config at full width and depth (on the meta device, so
    nothing is allocated): 12 blocks of 12 heads × 64 over dim 768."""
    model = SimpleViT(image_size=224, patch_size=16, num_classes=1000, dim=768,
                      depth=12, heads=12, mlp_dim=3072, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert model.grid == (14, 14)
    per_block = (2 * 2 * 768 + 768 * 2304 + 768 * 768
                 + 768 * 3072 + 3072 + 3072 * 768 + 768)
    assert n == (16 * 16 * 3 * 768 + 768) + 12 * per_block + 2 * 768 + 768 * 1000 + 1000
    assert model.transformer.layers_11_attn.to_qkv.weight.shape == (2304, 768)


def test_class_builds_on_the_card_by_default():
    """``SimpleViT`` with no device named is built on the card, or raises
    where there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert next(SimpleViT(device=None, **CFG).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimpleViT(**CFG)
    assert next(SimpleViT(device="cpu", **CFG).parameters()).device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax_gelu(jnp.asarray(x, dtype=dtype)).astype(jnp.float32))
    got = gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("hw,dim", [((14, 14), 768), ((4, 6), 64)])
def test_posemb_matches_jax(hw, dim):
    want = np.asarray(jax_posemb(hw[0], hw[1], dim))
    got = posemb_sincos_2d(hw[0], hw[1], dim).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("schedule", [(3, True), (4, False)])
@pytest.mark.parametrize("row_stochastic", [False, True])
def test_sinkhorn_scalings_match_jax(schedule, row_stochastic):
    iters, final_row = schedule
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 3, 11, 11)).astype(np.float32)
    attn = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    attn[0, 0, :, 4] = 0.0  # an exact-zero column takes the double-where branch
    a_j, b_j = jax_scalings(jnp.asarray(attn), num_iters=iters, final_row_norm=final_row,
                            assume_row_stochastic=row_stochastic)
    a_t, b_t = sinkhorn_scalings(torch.from_numpy(attn), num_iters=iters,
                                 final_row_norm=final_row,
                                 assume_row_stochastic=row_stochastic)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("extra", ["none", "bias", "mask"])
@pytest.mark.parametrize("robust", [False, True])
def test_dot_product_attention_matches_jax(robust, extra):
    """The plain q/k/v path, with an additive bias or a hard mask (a masked
    robust call keeps the first row normalization)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 3, 9, 16)).astype(np.float32) for _ in range(3))
    kw = {}
    if extra == "bias":
        kw["bias"] = rng.standard_normal((3, 9, 9)).astype(np.float32)
    elif extra == "mask":
        kw["mask"] = np.tril(np.ones((9, 9), dtype=bool))
    want = jax_dot_product_attention(
        *(jnp.asarray(t) for t in (q, k, v)), robust=robust, use_pallas=False,
        **{key: jnp.asarray(val) for key, val in kw.items()})
    got = dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), robust=robust,
        **{key: torch.from_numpy(val) for key, val in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=2e-5)


def test_package_imports_no_jax():
    code = ("import sys, noise_robust_vit_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'noise_robust_vit_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
