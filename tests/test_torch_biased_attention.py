"""The port's biased (windowed) attention against the JAX package's Pallas
kernel.

On the CPU the port runs its plain PyTorch versions (forward and the
hand-derived backward, dbias summed over the images that share a bias
row); the JAX side runs ``biased_attention`` in interpret mode, as
``tests/test_biased_attention.py`` does, at that file's shapes and
tolerances: forward atol 2e-6 / rtol 2e-5, dq, dk, dv and dbias atol 5e-6 /
rtol 5e-5, float32. Both get the same numpy inputs.

The ``gpu`` cases compare the CUDA kernels with the plain versions on the
card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_biased_attention.py -m gpu
"""

import types

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch.ops import biased_attention, biased_dispatch
from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba

torch.set_num_threads(1)

# (robust, sinkhorn_iters, final_row_norm): vanilla plus the two schedules
MODES = [(False, 3, True), (True, 3, True), (True, 4, False)]
MODE_IDS = ["vanilla", "robust-3-final", "robust-4"]


def _inputs(seed, bw, h, n, d, dv, nw):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((bw, h, n, d)).astype(np.float32) for _ in range(2))
    v, tang = (rng.standard_normal((bw, h, n, dv)).astype(np.float32) for _ in range(2))
    bias = rng.standard_normal((nw, h, n, n)).astype(np.float32)
    return q, k, v, bias, tang


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy and the Pallas biased kernel module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops.pallas import biased_attention as jba

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ba=jba)


def _jax_fwd_grads(jx, q, k, v, bias, tang, nw, robust, iters, final_row, no_bias=False):
    d = q.shape[-1]

    def f(q, k, v, bias):
        return jx.ba.biased_attention(q, k, v, bias, d**-0.5, robust, iters, final_row,
                                      nw, True, no_bias)

    out, vjp = jx.jax.vjp(f, *(jx.jnp.asarray(t) for t in (q, k, v, bias)))
    grads = vjp(jx.jnp.asarray(tang))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_fwd_grads(q, k, v, bias, tang, nw, robust, iters, final_row, no_bias=False):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v, bias)]
    out = biased_attention(*ts, scale=q.shape[-1] ** -0.5, robust=robust,
                           sinkhorn_iters=iters, final_row_norm=final_row,
                           num_windows=nw, no_bias=no_bias)
    out.backward(torch.from_numpy(tang))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("shape", [(8, 3, 23, 32, 32, 4), (4, 2, 17, 16, 32, 1)],
                         ids=["swin-like", "levit-like"])
def test_plain_forward_matches_jax_kernel(jx, robust, shape):
    """(BW, H, N, D, DV, nW): windows with a window count below the batch,
    and one per-head bias with DV ≠ D."""
    bw, h, n, d, dv, nw = shape
    q, k, v, bias, tang = _inputs(0, *shape)
    out_j, _ = _jax_fwd_grads(jx, q, k, v, bias, tang, nw, robust, 3, True)
    out_t, _ = _torch_fwd_grads(q, k, v, bias, tang, nw, robust, 3, True)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", [(8, 2, 19, 32, 32, 4), (4, 2, 17, 16, 32, 1)],
                         ids=["swin-like", "levit-like"])
def test_plain_gradients_match_jax_kernel(jx, mode, shape):
    robust, iters, final_row = mode
    nw = shape[-1]
    q, k, v, bias, tang = _inputs(1, *shape)
    out_j, grads_j = _jax_fwd_grads(jx, q, k, v, bias, tang, nw, robust, iters, final_row)
    out_t, grads_t = _torch_fwd_grads(q, k, v, bias, tang, nw, robust, iters, final_row)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=2e-5)
    for name, a, b in zip(["dq", "dk", "dv", "dbias"], grads_t, grads_j):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=5e-5, err_msg=name)


def test_dbias_sums_over_the_images_sharing_a_row(jx):
    """3 images × 2 windows: each bias row's gradient is the sum of three
    windows' logit gradients."""
    q, k, v, bias, tang = _inputs(2, 6, 1, 9, 16, 16, 2)
    _, grads_j = _jax_fwd_grads(jx, q, k, v, bias, tang, 2, True, 3, True)
    _, grads_t = _torch_fwd_grads(q, k, v, bias, tang, 2, True, 3, True)
    np.testing.assert_allclose(grads_t[3], grads_j[3], atol=5e-6, rtol=5e-5)


@pytest.mark.parametrize("robust", [False, True])
def test_no_bias_matches_jax_kernel(jx, robust):
    """``no_bias``: the bias operand is skipped and its gradient is zero."""
    q, k, v, bias, tang = _inputs(3, 8, 2, 21, 16, 16, 1)
    bias[:] = 0.0
    out_j, grads_j = _jax_fwd_grads(jx, q, k, v, bias, tang, 1, robust, 3, True, True)
    out_t, grads_t = _torch_fwd_grads(q, k, v, bias, tang, 1, robust, 3, True, True)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=2e-5)
    for name, a, b in zip(["dq", "dk", "dv"], grads_t, grads_j):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=5e-5, err_msg=name)
    assert not grads_t[3].any() and not grads_j[3].any()


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_residual_rows_match_jax_kernel(jx, mode):
    """The stored scaling vectors and log-normalizer are the JAX kernel's
    residual rows (its buffer pads rows to 8 and N to the 8-row tile)."""
    robust, iters, final_row = mode
    bw, h, n, d, dv, nw = 8, 2, 19, 32, 32, 4
    q, k, v, bias, _ = _inputs(4, bw, h, n, d, dv, nw)
    _, vecs_j = jx.ba._biased_fwd_impl(*(jx.jnp.asarray(t) for t in (q, k, v, bias)),
                                       d**-0.5, robust, iters, final_row, nw, True,
                                       want_vecs=True)
    r = ba.num_vecs(iters, final_row, robust)
    _, vecs_t = ba.biased_attention_fwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v, bias)), d**-0.5, robust, iters,
        final_row, nw)
    assert vecs_t.shape == (bw, h, r, n)
    np.testing.assert_allclose(vecs_t.numpy(), np.asarray(vecs_j)[:, :, :r, :n],
                               atol=2e-6, rtol=2e-5)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain version: no kernel is built or launched."""
    ba.launches.reset()
    _torch_fwd_grads(*_inputs(5, 4, 2, 9, 16, 16, 2), 2, True, 3, True)
    assert (ba.launches.fwd, ba.launches.bwd) == (0, 0)


@pytest.mark.parametrize("shape,iters,ok", [
    ((8192, 3, 49, 32, 32, 64), 3, True),    # swin_t stage 0
    ((128, 24, 49, 32, 32, 1), 3, True),     # swin_t stage 3
    ((2048, 3, 64, 32, 32, 64), 3, True),    # swin_v2_t stage 0
    ((256, 4, 196, 16, 32, 1), 4, True),     # LeViT
    ((256, 4, 196, 16, 32, 1), 5, False),    # LeViT, too many chain vectors
    ((64, 4, 196, 32, 64, 1), 4, True),      # LeViT-256 stage 0: o/a, t1 in chunks
    ((64, 4, 196, 32, 64, 1), 5, False),     # ... too many chain vectors
    ((64, 4, 196, 32, 40, 1), 3, False),     # DV too wide, no 32-column chunks
    ((8192, 8, 49, 64, 64, 1), 3, True),     # Twins local
    ((8, 3, 197, 32, 32, 1), 3, False),      # N above MAX_N
    ((8, 3, 49, 36, 36, 1), 3, False),       # D not a multiple of 8
    ((9, 3, 49, 32, 32, 2), 3, False),       # BW not a multiple of nW
])
def test_gate(shape, iters, ok):
    assert ba.biased_attention_supported(*shape, sinkhorn_iters=iters) is ok
    assert biased_dispatch(True, *shape, iters) is ok
    assert biased_dispatch(False, *shape, iters) is False


def test_cuda_wrapper_refuses_cpu_tensor():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ba.biased_attention_fwd_cuda(q, q, q, torch.zeros(1, 1, 4, 4), 0.25)


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(ts, nw, robust, iters, final_row, no_bias=False):
    q, k, v, bias, g = ts
    args = (q.shape[-1] ** -0.5, robust, iters, final_row, nw, no_bias)
    out_k, vecs_k = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
    grads_k = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs_k, *args)
    out_p, vecs_p = ba.biased_attention_fwd_plain(q, k, v, bias, *args)
    grads_p = ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs_p, *args)
    torch.cuda.synchronize()
    return (out_k, vecs_k, *grads_k), (out_p, vecs_p, *grads_p)


def _assert_kernel_matches(got, want):
    """float32: atol 1e-4 / rtol 1e-3, the sums run in another order than
    the plain version's and the reverse chain amplifies it. bfloat16 in and
    out, float32 inside: outputs agree to a bf16 rounding of values of order
    one (atol 2e-2); dbias is float32 but sums bf16-rounded inputs' logit
    gradients over the images, so it gets atol 2e-2 / rtol 2e-2 too."""
    names = ["out", "vecs", "dq", "dk", "dv", "dbias"]
    for name, g, w in zip(names, got, want):
        if g is None:
            assert w is None, name
            continue
        if got[0].dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3, msg=name)
        elif name == "vecs":
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        elif name == "out":
            torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=0, msg=name)
        else:
            torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2, msg=name)


def _card_inputs(seed, shape, device, dtype):
    q, k, v, bias, g = (torch.from_numpy(t).to(device) for t in _inputs(seed, *shape))
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, g.to(dtype)


CARD_SHAPES = [(8, 3, 23, 32, 32, 4), (4, 2, 17, 16, 32, 1), (64, 3, 49, 32, 32, 16),
               (16, 3, 64, 32, 32, 4), (4, 4, 196, 16, 32, 1), (32, 8, 49, 64, 64, 1),
               (4, 4, 196, 32, 64, 1), (2, 2, 196, 16, 128, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, mode, dtype):
    robust, iters, final_row = mode
    ts = _card_inputs(6, shape, cuda, dtype)
    _assert_kernel_matches(*_kernel_vs_plain(ts, shape[-1], robust, iters, final_row))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_kernel_no_bias_matches_plain(cuda, mode):
    robust, iters, final_row = mode
    ts = _card_inputs(7, (32, 8, 49, 64, 64, 1), cuda, torch.float32)
    _assert_kernel_matches(*_kernel_vs_plain(ts, 1, robust, iters, final_row, True))


@pytest.mark.gpu
def test_dbias_repeats_bit_for_bit(cuda):
    """Many images per bias row, so the backward sums partials from several
    chunks: two runs give the same bits (no atomics)."""
    ts = _card_inputs(8, (1024, 3, 49, 32, 32, 4), cuda, torch.bfloat16)
    q, k, v, bias, g = ts
    args = (32**-0.5, True, 3, True, 4, False)
    _, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
    first = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args)[3]
    again = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args)[3]
    assert ba._chunks(cuda, 4 * 3, 256)[0] > 1
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("robust", [False, True])
def test_autograd_on_card_launches_kernels(cuda, robust):
    """``biased_attention`` on CUDA tensors goes through both kernels, once
    each, and its output and gradients agree with the CPU path."""
    shape = (8, 3, 49, 32, 32, 4)
    q, k, v, bias, tang = _inputs(9, *shape)
    want = _torch_fwd_grads(q, k, v, bias, tang, 4, robust, 3, True)
    ts = [torch.from_numpy(t).to(cuda).requires_grad_(True) for t in (q, k, v, bias)]
    ba.launches.reset()
    out = biased_attention(*ts, robust=robust, num_windows=4)
    out.backward(torch.from_numpy(tang).to(cuda))
    torch.cuda.synchronize()
    assert (ba.launches.fwd, ba.launches.bwd) == (1, 1)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want[0], atol=1e-4, rtol=1e-3)
    for t, w in zip(ts, want[1]):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w, atol=1e-4, rtol=1e-3)
