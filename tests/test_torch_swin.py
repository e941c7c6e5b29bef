"""The port's Swin slice against the JAX package, on the CPU in float32.

A small JAX ``SwinTransformer`` (patch 4, embed 16, depths (2, 2), heads
(2, 2), window 4) is initialized, its parameters are carried across with
``convert_params``, and logits and every parameter gradient of the mean
cross-entropy are compared at ``test_biased_attention.py``'s model
tolerances: 1e-5 / 1e-4 and 2e-5 / 2e-4. At 32×32 stage 0 has a shifted
block (with the shift mask) and an unshifted one, and stage 1's window
covers its map, so its shift is forced to 0; at 24×24 both maps are padded
to the window (v1 only: in v2 a padded token's q is zero, and the JAX
package's gradient of its norm there is NaN; torch's is zero). Robust
models run the biased attention (its plain version here; JAX runs its
Pallas kernel in interpret mode), vanilla ones the batched matmuls and a
softmax. The window geometry, ``DropPath``, the
weight bridge at Swin-T's full tree and the device rule of the entry points
are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from noise_robust_vit_tpu import models as jax_models
from noise_robust_vit_tpu import ops as jax_ops
from noise_robust_vit_tpu.ops import windows as jax_windows
from noise_robust_vit_tpu_torch import SwinTransformer, convert_params, create_model
from noise_robust_vit_tpu_torch.models import swin
from noise_robust_vit_tpu_torch.models.layers import DropPath
from noise_robust_vit_tpu_torch.ops import drop_path, windows
from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba

torch.set_num_threads(1)

CFG = dict(patch_size=(4, 4), embed_dim=16, depths=(2, 2), num_heads=(2, 2),
           window_size=(4, 4), num_classes=5, stochastic_depth_prob=0.0)


@pytest.mark.parametrize("version,image", [(1, 32), (1, 24), (2, 32)])
@pytest.mark.parametrize("robust", [False, True])
def test_logits_and_grads_match_jax(robust, version, image):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, image, image, 3)).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=2)

    jmodel = jax_models.SwinTransformer(robust=robust, version=version, **CFG)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(y)).mean(), logits

    try:
        jax_ops.set_use_pallas(True)
        (_, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        jax_ops.set_use_pallas(None)

    model = SwinTransformer(robust=robust, version=version, device="cpu", **CFG)
    model.load_state_dict(convert_params(params), strict=True)
    ba.launches.reset()
    logits_t = model(torch.from_numpy(x))
    F.cross_entropy(logits_t.float(), torch.from_numpy(y)).backward()
    assert (ba.launches.fwd, ba.launches.bwd) == (0, 0)  # CPU: plain versions

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-4)
    grads_t = {k: p.grad for k, p in model.named_parameters()}
    grads_j = convert_params(jax.device_get(grads_j))
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_j.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(),
                                   atol=2e-5, rtol=2e-4, err_msg=name)


def test_robust_swin_takes_the_biased_attention(monkeypatch):
    """Every robust block runs ``ops.biased_attention`` with the merged
    bias; a vanilla one never does."""
    calls = []
    real = swin.ops.biased_attention

    def spy(q, k, v, bias, **kw):
        calls.append((tuple(q.shape), tuple(bias.shape), kw["num_windows"]))
        return real(q, k, v, bias, **kw)

    monkeypatch.setattr(swin.ops, "biased_attention", spy)
    x = torch.zeros(2, 32, 32, 3)
    SwinTransformer(robust=False, device="cpu", **CFG)(x)
    assert calls == []
    SwinTransformer(robust=True, device="cpu", **CFG)(x)
    stage0, stage1 = ((8, 2, 16, 8), (4, 2, 16, 16), 4), ((2, 2, 16, 16), (1, 2, 16, 16), 1)
    assert calls == [stage0, stage0, stage1, stage1]


@pytest.mark.parametrize("hw,window", [((8, 8), (4, 4)), ((14, 21), (7, 7))])
def test_window_partition_round_trip_matches_jax(hw, window):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_windows.window_partition(jnp.asarray(x), window))
    got = windows.window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    back = windows.window_reverse(got, window, hw, 2)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("shift,reverse", [((2, 2), False), ((3, 1), True), ((0, 0), False)])
def test_cyclic_shift_matches_jax(shift, reverse):
    x = np.arange(2 * 6 * 7 * 3, dtype=np.float32).reshape(2, 6, 7, 3)
    want = np.asarray(jax_windows.cyclic_shift(jnp.asarray(x), shift, reverse))
    got = windows.cyclic_shift(torch.from_numpy(x), shift, reverse)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [(7, 7), (8, 8), (4, 3)])
def test_geometry_tables_match_jax(window):
    np.testing.assert_array_equal(windows.relative_position_index(*window),
                                  jax_windows.relative_position_index(*window))
    np.testing.assert_array_equal(windows.relative_coords_table(*window),
                                  jax_windows.relative_coords_table(*window))
    wh, ww = window
    for pad, shift in [((4 * wh, 4 * ww), (wh // 2, ww // 2)), ((2 * wh, 2 * ww), (0, 0))]:
        got = windows.shift_attn_mask(*pad, window, shift)
        want = jax_windows.shift_attn_mask(*pad, window, shift)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_drop_path_identity_in_eval_and_at_rate_zero():
    x = torch.randn(8, 3, 4)
    layer = DropPath(0.5).eval()
    assert layer(x) is x
    assert DropPath(0.0).train()(x) is x
    assert drop_path(x, 0.5, None, deterministic=True) is x


def test_drop_path_drops_whole_samples_and_rescales():
    """In training each sample is either 0 or x / keep, drawn from the
    layer's generator: the same seed draws the same samples."""
    x = torch.randn(256, 3, 4) + 5.0
    layer = DropPath(0.25).train()
    layer.generator = torch.Generator().manual_seed(7)
    y = layer(x)
    dropped = (y == 0).flatten(1).all(1)
    kept = torch.isclose(y, x / 0.75).flatten(1).all(1)
    assert bool((dropped | kept).all())
    assert 0.1 < dropped.float().mean().item() < 0.4
    layer.generator = torch.Generator().manual_seed(7)
    assert torch.equal(layer(x), y)


@pytest.mark.parametrize("name,count", [("swin_t", 28_288_354), ("swin_v2_t", 28_351_570)])
def test_full_width_parameter_count(name, count):
    """torchvision's Swin-T and Swin-V2-T at 1000 classes, on the meta
    device (nothing allocated)."""
    model = create_model(name, num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


def test_swin_t_jax_tree_loads_strictly():
    """The weight bridge maps a JAX swin_t tree (shapes only; zeros) onto
    the port's state_dict with strict loading: the HWIO patch kernel, the
    relative-position tables and every Dense and LayerNorm."""
    jmodel = jax_models.swin_t(num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = create_model("swin_t", num_classes=1000, device="cpu")
    state = convert_params(tree)
    assert state["patch_embed.weight"].shape == (96, 3, 4, 4)
    model.load_state_dict(state, strict=True)


def test_conv_kernel_maps_hwio_to_oihw():
    kernel = np.arange(4 * 4 * 3 * 8, dtype=np.float32).reshape(4, 4, 3, 8)
    got = convert_params({"patch_embed": {"kernel": kernel}})["patch_embed.weight"]
    np.testing.assert_array_equal(got.numpy(), kernel.transpose(3, 2, 0, 1))


def test_entry_points_build_on_the_card_by_default():
    """No device named: the model is built on the card, or the call raises
    where there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        model = create_model("swin_t", num_classes=10)
        assert next(model.parameters()).is_cuda
        assert next(swin.swin_t(num_classes=10).parameters()).is_cuda
        assert next(SwinTransformer(**CFG).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("swin_t", num_classes=10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            swin.swin_t(num_classes=10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SwinTransformer(**CFG)
    model = create_model("swin_t", num_classes=10, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
