"""The port's fused LayerNorm against the JAX package's Pallas kernel
(``ops/pallas/fused_ln.py::fused_layer_norm``), its module
(``ops/norms.py::FusedLayerNorm``) and the shared blocks' rule that picks
it by feature width (``models/layers.py::_ln_cls``).

On the CPU the port runs its plain PyTorch versions (two-pass float32
moments, the hand-derived backward); the JAX side runs ``fused_layer_norm``
in interpret mode, as ``tests/test_fused_ln.py`` does, on the same numpy
inputs and upstream gradient. Tolerances: JAX's own, forward atol and rtol
1e-5, the gradients of x, scale and bias atol 2e-4 and rtol 1e-4; a bf16
output to one bf16 ulp (rtol 8e-3); the SimpleViT's fused block norms
against plain ones at the suite's 1e-5 (logits) and 5e-5 (gradients).

The ``gpu`` cases compare the CUDA kernels with the plain versions on the
card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fused_ln.py -m gpu
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from noise_robust_vit_tpu_torch import CvT, SimpleViT, SwinTransformer, convert_params
from noise_robust_vit_tpu_torch.models import cvt as cvt_module
from noise_robust_vit_tpu_torch.models.layers import (Attention, FeedForward, LayerNorm,
                                                      Transformer, _ln_cls)
from noise_robust_vit_tpu_torch.ops.cuda import fused_ln as fl
from noise_robust_vit_tpu_torch.ops.norms import FusedLayerNorm

torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)
SVIT = dict(image_size=16, patch_size=8, num_classes=4, dim=128, depth=1, heads=2, mlp_dim=128)


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy and the Pallas kernel module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops.pallas import fused_ln as pk

    return jax, jax.numpy, pk


def _inputs(seed, shape):
    """x (N(1, 3²): the mean must come off), scale near 1, bias, dy."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (1.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    g = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, dy


def _port_vjp(x, g, b, dy):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    out = fl.fused_layer_norm(*leaves, 1e-5)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_vjp(jx, x, g, b, dy):
    jax, jnp, pk = jx
    out, vjp = jax.vjp(lambda *a: pk.fused_layer_norm(*a, 1e-5, True),
                       *(jnp.asarray(a) for a in (x, g, b)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("rows", [64, 500])  # 500: JAX pads to 512 rows
@pytest.mark.parametrize("d", [128, 768])
def test_plain_matches_jax_kernel(jx, rows, d):
    x, g, b, dy = _inputs(rows + d, (rows, d))
    out_t, grads_t = _port_vjp(x, g, b, dy)
    out_j, grads_j = _jax_vjp(jx, x, g, b, dy)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    for name, a, r in zip(("dx", "dscale", "dbias"), grads_t, grads_j):
        np.testing.assert_allclose(a, r, err_msg=name, **GRAD_TOL)


def test_plain_matches_jax_kernel_on_3d_input(jx):
    """``[B, N, D]`` input: the rows are the leading dims flattened."""
    x, g, b, dy = _inputs(1, (2, 5, 128))
    out_t, grads_t = _port_vjp(x, g, b, dy)
    out_j, grads_j = _jax_vjp(jx, x, g, b, dy)
    assert out_t.shape == (2, 5, 128) and grads_t[0].shape == (2, 5, 128)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    for name, a, r in zip(("dx", "dscale", "dbias"), grads_t, grads_j):
        np.testing.assert_allclose(a, r, err_msg=name, **GRAD_TOL)


def test_plain_backward_is_the_layer_norm_vjp():
    """The hand-derived backward against autograd through the forward's own
    float32 math."""
    x, g, b, dy = _inputs(2, (33, 256))
    _, grads_t = _port_vjp(x, g, b, dy)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, g, b)]
    F.layer_norm(leaves[0], (256,), leaves[1], leaves[2], 1e-5).backward(
        torch.from_numpy(dy).double())
    for name, a, r in zip(("dx", "dscale", "dbias"), grads_t, leaves):
        np.testing.assert_allclose(a, r.grad.numpy(), err_msg=name, **GRAD_TOL)


def test_gate_is_jax_gate(jx):
    """``fused_ln_supported`` contains JAX's ``fused_ln_supported`` (D a
    multiple of 128, the TPU's lane width) at every positive D up to and
    past 8192, and is exactly the multiples of 32 from 32 to 8192: a chosen
    difference, since on the card a row splits into runs of four over 8
    lanes."""
    pk = jx[2]
    port = [d for d in range(1, 9000) if fl.fused_ln_supported(d)]
    jax_gate = [d for d in range(1, 9000) if pk.fused_ln_supported(d)]
    assert jax_gate and set(jax_gate) <= set(port)
    assert port == list(range(32, 8193, 32))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the kernel wrappers refuse CPU tensors."""
    x, g, b, dy = (torch.from_numpy(a) for a in _inputs(3, (8, 128)))
    fl.launches.reset()
    y = fl.fused_ln_fwd(x, g, b)
    dx, dg, db = fl.fused_ln_bwd(x, g, dy)
    assert (fl.launches.fwd, fl.launches.bwd) == (0, 0)
    torch.testing.assert_close(y, fl.fused_ln_fwd_plain(x, g, b), rtol=0, atol=0)
    assert dx.dtype == x.dtype and dg.dtype == db.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.fused_ln_fwd_cuda(x, g, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.fused_ln_bwd_cuda(x, g, dy)


@pytest.mark.parametrize("d", [128, 120], ids=["kernel_path", "outside_gate"])
def test_module_matches_jax_module_bf16_on_f32_input(jx, d):
    """``FusedLayerNorm(dtype=bf16)`` on a float32 x against JAX's module.
    D = 128 casts x to bf16 before normalizing (JAX's
    ``fused_layer_norm(x.astype(dtype), ...)``): the port's plain
    ``LayerNorm``, which normalizes the float32 x and casts afterwards,
    rounds a third of the entries differently, and the fused module agrees
    with JAX to one bf16 ulp. D = 120, outside both gates, takes the
    other branch, the float32 two-pass math on the uncast x, cast after."""
    jax, jnp, _ = jx
    from noise_robust_vit_tpu.ops.norms import FusedLayerNorm as JaxFusedLayerNorm

    x, g, b, _ = _inputs(4, (64, d))
    jmod = JaxFusedLayerNorm(dtype=jnp.bfloat16)
    want = np.asarray(jmod.apply({"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}},
                                 jnp.asarray(x)).astype(jnp.float32))
    state = convert_params({"scale": g, "bias": b})
    mod = FusedLayerNorm(d, dtype=torch.bfloat16, device="cpu")
    mod.load_state_dict(state, strict=True)
    got = mod(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-6)
    assert (got != want).mean() <= 0.01
    plain = LayerNorm(d, dtype=torch.bfloat16, device="cpu")
    plain.load_state_dict(state, strict=True)
    after = plain(torch.from_numpy(x)).float().detach().numpy()
    if d == 128:
        assert (after != want).mean() > 0.1
    else:
        np.testing.assert_allclose(after, want, rtol=8e-3, atol=1e-6)


def test_switch_picks_the_class(monkeypatch):
    """The shared blocks' class is a rule on the width alone: the retired
    ``NRV_FUSED_LN`` variable changes nothing, set or not. A SimpleViT at D
    128 holds ``FusedLayerNorm`` in its block norms and the plain class in
    its head norm, as JAX's does with its switch on."""
    for value in (None, "1"):
        if value is None:
            monkeypatch.delenv("NRV_FUSED_LN", raising=False)
        else:
            monkeypatch.setenv("NRV_FUSED_LN", value)
        assert _ln_cls(128) is FusedLayerNorm and _ln_cls(96) is FusedLayerNorm
        assert _ln_cls(120) is LayerNorm
    model = SimpleViT(device="cpu", **SVIT)
    fused = [n for n, m in model.named_modules() if isinstance(m, FusedLayerNorm)]
    assert fused == ["transformer.layers_0_attn.norm", "transformer.layers_0_ff.norm"]
    assert type(model.head_norm) is LayerNorm  # left plain, as in JAX


@pytest.mark.parametrize("d,fused", [(96, True), (64, True), (192, True), (120, False),
                                     (144, False), (8320, False), (128, True), (768, True),
                                     (8192, True)])
def test_blocks_pick_the_class_by_width(d, fused):
    """``FeedForward``, ``Attention`` and ``Transformer`` build
    ``FusedLayerNorm`` where D is inside the kernels' gate (a multiple of
    32 up to 8192: MobileViT-XS's and Swin-T's 96, CvT-13's 64 and 192),
    else the plain ``LayerNorm`` (MobileViT-XS's 120 and 144; 8320 past the
    largest)."""
    want = FusedLayerNorm if fused else LayerNorm
    assert fl.fused_ln_supported(d) == fused
    assert _ln_cls(d) is want
    blocks = (FeedForward(d, 8, device="meta"), Attention(d, heads=1, dim_head=8, device="meta"),
              Transformer(d, 0, 1, 8, 8, final_norm=True, device="meta"))
    for block in blocks:
        assert type(block.norm) is want
        assert block.norm.weight.shape == block.norm.bias.shape == (d,)


def test_simple_vit_at_768_fuses_its_block_norms():
    """A depth-1 SimpleViT at SimpleViT-B/16's width: the two block norms
    are ``FusedLayerNorm``, the head norm the plain class."""
    model = SimpleViT(image_size=32, patch_size=16, num_classes=4, dim=768, depth=1, heads=12,
                      mlp_dim=64, device="cpu")
    by_class = {n: type(m) for n, m in model.named_modules()
                if isinstance(m, (FusedLayerNorm, LayerNorm))}
    assert by_class == {"transformer.layers_0_attn.norm": FusedLayerNorm,
                        "transformer.layers_0_ff.norm": FusedLayerNorm,
                        "head_norm": LayerNorm}


@pytest.mark.parametrize("name,image,widths", [
    ("swin_t", 32, {96: 5, 192: 4, 384: 13, 768: 6, 1536: 1}),
    ("cvt_13", 64, {64: 3, 192: 5, 384: 21})])
def test_swin_t_and_cvt_13_norms_take_the_fused_kernels(monkeypatch, name, image, widths):
    """Every LayerNorm of Swin-T (``FusedLayerNorm``: the patch norm, two a
    block, the three merges at 4·C and the last) and every channel norm of
    CvT-13 (``_ChannelLN``, which calls the fused function) runs
    ``FusedLayerNormFn``: 29 calls a forward, by width."""
    from noise_robust_vit_tpu_torch import create_model

    model = create_model(name, num_classes=10, image_size=224, device="cpu")
    got = []
    real = fl.FusedLayerNormFn.apply
    monkeypatch.setattr(fl.FusedLayerNormFn, "apply",
                        lambda x, *a: got.append(x.shape[-1]) or real(x, *a))
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3))
    kinds = [type(m).__name__ for m in model.modules()
             if isinstance(m, (FusedLayerNorm, LayerNorm, cvt_module._ChannelLN))]
    assert len(got) == len(kinds) == 29
    assert set(kinds) == {"FusedLayerNorm" if name == "swin_t" else "_ChannelLN"}
    assert {d: got.count(d) for d in widths} == widths and len(got) == sum(widths.values())


@pytest.mark.parametrize("d", [64, 192, 384])
def test_cvt_channel_norm_bf16_is_at_least_as_close_as_jax(jx, d):
    """In bf16 the port's CvT channel norm (the fused math: float32
    moments, y rounded once) is at least as close to a float64 LayerNorm
    of the same bf16 inputs as JAX's ``_ChannelLN``, which computes in the
    input's dtype: a chosen difference from JAX, by the largest and the
    mean error."""
    jax, jnp, _ = jx
    from noise_robust_vit_tpu.models.cvt import _ChannelLN as JaxChannelLN

    x, g, b, _ = _inputs(d, (2, 6, 6, d))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mod = cvt_module._ChannelLN(d, device="cpu")
    mod.load_state_dict({"g": torch.from_numpy(g), "b": torch.from_numpy(b)})
    port = mod(xb).detach().double()
    want = F.layer_norm(xb.double(), (d,), torch.from_numpy(g).double(),
                        torch.from_numpy(b).double(), 1e-5)
    jmod = JaxChannelLN(dim=d)
    j = jmod.apply({"params": {"g": jnp.asarray(g), "b": jnp.asarray(b)}},
                   jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert j.dtype == jnp.bfloat16 and port.dtype == torch.float64
    jerr = (torch.from_numpy(np.array(j.astype(jnp.float32))).double() - want).abs()
    perr = (port - want).abs()
    assert perr.max() <= jerr.max() and perr.mean() <= jerr.mean()


def _svit_step(params, x, y, fused):
    """Logits and gradients of the port's SimpleViT loaded with ``params``:
    as built (the block norms on ``FusedLayerNorm`` at D 128), or with
    every block norm swapped for the plain ``LayerNorm`` before loading."""
    model = SimpleViT(robust=True, device="cpu", **SVIT)
    if not fused:
        for block in (model.transformer.layers_0_attn, model.transformer.layers_0_ff):
            block.norm = LayerNorm(SVIT["dim"], eps=block.norm.eps, device="cpu")
    assert isinstance(model.transformer.layers_0_ff.norm, FusedLayerNorm) == fused
    model.load_state_dict(convert_params(params), strict=True)
    logits = model(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    return logits.detach().numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()}


def test_switch_keeps_logits_and_grads_and_matches_jax(jx, monkeypatch):
    """A small robust SimpleViT (D 128, inside the gate) as built, on
    ``FusedLayerNorm``, and with its block norms swapped for the plain
    class, loaded with the same converted weights: the same logits and
    gradients, and both match JAX's model applied with its ``NRV_FUSED_LN``
    switch on (JAX's FusedLayerNorm in interpret mode)."""
    jax, jnp, _ = jx
    import optax

    from noise_robust_vit_tpu import SimpleViT as JaxSimpleViT

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, SVIT["num_classes"], size=2)
    jmodel = JaxSimpleViT(robust=True, **SVIT)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    monkeypatch.setenv("NRV_FUSED_LN", "1")
    (_, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    monkeypatch.delenv("NRV_FUSED_LN")
    grads_j = convert_params(jax.device_get(grads_j))

    plain = _svit_step(params, x, y, False)
    fused = _svit_step(params, x, y, True)
    for logits_t, grads_t in (fused, plain):
        np.testing.assert_allclose(logits_t, np.asarray(logits_j), atol=1e-5, rtol=1e-5)
        assert grads_t.keys() == grads_j.keys()
        for name, g in grads_j.items():
            np.testing.assert_allclose(grads_t[name], g.numpy(), atol=5e-5, rtol=5e-5,
                                       err_msg=name)
    np.testing.assert_allclose(fused[0], plain[0], atol=1e-5, rtol=1e-5)
    for name, g in plain[1].items():
        np.testing.assert_allclose(fused[1][name], g, atol=5e-5, rtol=5e-5, err_msg=name)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(cuda, seed, rows, d, dtype):
    x, g, b, dy = _inputs(seed, (rows, d))
    return (torch.from_numpy(x).to(cuda, dtype), torch.from_numpy(g).to(cuda),
            torch.from_numpy(b).to(cuda), torch.from_numpy(dy).to(cuda, dtype))


def _kernel_vs_plain(x, g, b, dy):
    got = (fl.fused_ln_fwd_cuda(x, g, b), *fl.fused_ln_bwd_cuda(x, g, dy))
    torch.cuda.synchronize()
    want = (fl.fused_ln_fwd_plain(x, g, b), *fl.fused_ln_bwd_plain(x, g, dy))
    return got, want


def assert_kernel_matches(got, want):
    """y and dx: float32 atol 1e-5 and rtol 1e-5 (rsqrt and the sums' order
    differ); bf16 one bf16 ulp (rtol 8e-3) and atol 1e-2 for values near 0.
    dscale and dbias, sums over every row in another order: rtol 1e-4 and
    atol 1e-5 of the tensor's largest magnitude."""
    bf16 = got[0].dtype == torch.bfloat16
    for name, a, b in zip(("y", "dx"), got[:2], want[:2]):
        if bf16:
            torch.testing.assert_close(a.float(), b.float(), atol=1e-2, rtol=8e-3, msg=name)
        else:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
    for name, a, b in zip(("dscale", "dbias"), got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(), rtol=1e-4, msg=name)


# the warp path (D a multiple of 128 up to 1024), the 8-lane path (the other
# widths up to 256: odd row counts and one row), the block path (the rest)
CARD_CASES = [(50176, 768), (500, 128), (1, 768), (500, 1024), (500, 1280), (63, 8192),
              (1, 8192), (300, 384), (333, 32), (1, 32), (1001, 64), (1, 64), (4099, 96),
              (1, 96), (517, 160), (1, 160), (2047, 192), (1, 192), (77, 320), (45, 1056)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rows,d", CARD_CASES)
def test_kernel_matches_plain(cuda, rows, d, dtype):
    assert_kernel_matches(*_kernel_vs_plain(*_card(cuda, rows + d, rows, d, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(50176, 768), (500, 1280), (4099, 96)])
def test_kernel_repeats_bit_for_bit(cuda, rows, d):
    """No atomics: the dscale/dbias partials are summed in a fixed order,
    so two runs give the same bits."""
    inputs = _card(cuda, 11, rows, d, torch.bfloat16)
    first = _kernel_vs_plain(*inputs)[0]
    again = _kernel_vs_plain(*inputs)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_kernel_refuses_outside_the_gate(cuda):
    """120 is no multiple of 32; 8224 is one, past 8192."""
    for d in (120, 8224):
        x, g, b, dy = _card(cuda, 12, 8, d, torch.float32)
        with pytest.raises(ValueError, match="outside the gate"):
            fl.fused_ln_fwd_cuda(x, g, b)
        with pytest.raises(ValueError, match="outside the gate"):
            fl.fused_ln_bwd_cuda(x, g, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("d,launched", [(128, 1), (96, 1), (64, 1), (120, 0)])
def test_module_on_card_launches_inside_the_gate(cuda, d, launched):
    """``FusedLayerNorm`` on CUDA tensors: one forward and one backward
    launch inside the gate, none outside it; the CPU path agrees."""
    x, g, b, dy = _inputs(13, (4, 9, d))
    outs = []
    for dev in ("cpu", cuda):
        mod = FusedLayerNorm(d, device=dev)
        mod.load_state_dict({"weight": torch.from_numpy(g), "bias": torch.from_numpy(b)})
        xx = torch.from_numpy(x).to(dev).requires_grad_(True)
        fl.launches.reset()
        out = mod(xx)
        out.backward(torch.from_numpy(dy).to(dev))
        outs.append((out.detach().cpu(), xx.grad.cpu(), mod.weight.grad.cpu(),
                     (fl.launches.fwd, fl.launches.bwd)))
    assert outs[0][3] == (0, 0) and outs[1][3] == (launched, launched)
    for a, b in zip(outs[1][:3], outs[0][:3]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_simple_vit_step_launches_the_kernels(cuda):
    """One bf16 train step of a depth-2 SimpleViT at D 768 runs its four
    block norms on the kernels: 4 forward and 4 backward launches (the head
    norm stays plain), and the loss is finite."""
    from noise_robust_vit_tpu_torch.train import create_train_state

    model = SimpleViT(image_size=32, patch_size=16, num_classes=4, dim=768, depth=2, heads=12,
                      mlp_dim=256, dtype=torch.bfloat16, device=cuda)
    state = create_train_state(model)
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(8, 32, 32, 3, generator=gen, device=cuda).to(torch.bfloat16)
    y = torch.randint(0, 4, (8,), generator=gen, device=cuda)
    fl.launches.reset()
    loss = state.train_step(x, y)
    torch.cuda.synchronize()
    assert (fl.launches.fwd, fl.launches.bwd) == (4, 4)
    assert torch.isfinite(loss)


# a depth-reduced Swin-T (one block a stage: 13 norms at 96 to 1536) and
# CvT-13 (one block a stage: 9 channel norms at 64, 192 and 384), vanilla,
# float32, at 112 and 64 px
NORM_MODELS = {
    "swin_t_depth_1": (SwinTransformer, dict(patch_size=(4, 4), embed_dim=96, depths=(1, 1, 1, 1),
                                             num_heads=(3, 6, 12, 24), window_size=(7, 7),
                                             num_classes=10, stochastic_depth_prob=0.0),
                       112, False, 13),
    "cvt_13_depth_1": (CvT, dict(num_classes=10, s1_depth=1, s2_depth=1, s3_depth=1), 64, True, 9),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NORM_MODELS))
def test_model_step_runs_its_norms_on_the_kernels(cuda, name):
    """One forward and backward of 4 images (CvT in train mode) on the card
    and on the CPU from the same weights: one forward and one backward launch
    a norm on the card, none on the CPU; logits within atol and rtol 1e-4,
    every gradient within ``GRAD_TOL``'s rtol and its atol times the
    tensor's largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cls, kwargs, image, train, norms = NORM_MODELS[name]
    cpu = cls(device="cpu", **kwargs)
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    card = cls(device=cuda, **kwargs)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(4, image, image, 3, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        model.train(train)
        fl.launches.reset()
        logits = model(x.to(dev))
        F.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        outs.append((logits.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                     (fl.launches.fwd, fl.launches.bwd)))
    assert outs[0][2] == (0, 0) and outs[1][2] == (norms, norms)
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * g.abs().max().item(), msg=k)
