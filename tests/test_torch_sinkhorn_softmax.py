"""The port's logits-interface Sinkhorn softmax (square and rectangular)
against the JAX package's Pallas kernels.

On the CPU the port runs its plain PyTorch versions (forward and the
hand-derived backward from the stored residual rows); the JAX side runs
``sinkhorn_softmax`` and ``sinkhorn_softmax_rect`` in interpret mode, as
``tests/test_sinkhorn_softmax.py`` does. Both get the same numpy logits and
the same upstream gradient. Tolerances, float32, the JAX suite's own
(``tests/test_parity.py``): values and residual rows atol 1e-5 / rtol 1e-4,
d logits atol 5e-5 / rtol 1e-4.

The ``gpu`` cases compare the CUDA kernels with the plain versions on the
card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_sinkhorn_softmax.py -m gpu
"""

import types

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch import ops
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss

torch.set_num_threads(1)

# (sinkhorn_iters, final_row_norm)
SCHEDULES = [(3, True), (4, False), (4, True)]
SCHEDULE_IDS = ["3-final", "4", "4-final"]
# LeViT-128S's subsample logits at batch 2, square logits at nest_tiny's
# N = 196, and ragged ones (no multiple of 4 along a row), nr > nc
SHAPES = [(2, 8, 49, 196), (2, 16, 16, 49), (2, 4, 196, 196), (2, 3, 33, 7), (2, 3, 45, 45)]
SHAPE_IDS = ["levit-sub0", "levit-sub1", "square-196", "ragged-rect", "ragged-square"]
VALUES = dict(atol=1e-5, rtol=1e-4)
GRADS = dict(atol=5e-5, rtol=1e-4)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    return logits, rng.standard_normal(shape).astype(np.float32)


def _square(shape):
    return shape[-1] == shape[-2]


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy and the Pallas kernel module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops.pallas import sinkhorn_softmax as jss

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ss=jss)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax_kernel(jx, shape, schedule):
    """Weights and d logits (through ``jax.vjp``) of the plain versions
    against the interpret-mode Pallas kernels."""
    iters, final_row = schedule
    logits, g = _inputs(0, shape)
    fn = jx.ss.sinkhorn_softmax if _square(shape) else jx.ss.sinkhorn_softmax_rect
    out_j, vjp = jx.jax.vjp(lambda s: fn(s, iters, final_row, True), jx.jnp.asarray(logits))
    (ds_j,) = vjp(jx.jnp.asarray(g))

    x = torch.from_numpy(logits).requires_grad_(True)
    out_t = ops.sinkhorn_attention(x, num_iters=iters, final_row_norm=final_row)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **VALUES)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ds_j), **GRADS)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_residual_rows_match_jax_kernel(jx, shape, schedule):
    """The stored scaling vectors and log-normalizer are the JAX kernels'
    residual rows (which pad rows and widths to the 8-row tile)."""
    iters, final_row = schedule
    logits, _ = _inputs(1, shape)
    s = jx.jnp.asarray(logits)
    x = torch.from_numpy(logits)
    nr, nc = shape[-2:]
    if _square(shape):
        _, vecs_j = jx.ss._sinkhorn_softmax_fwd_impl(s, iters, final_row, True, want_vecs=True)
        _, vecs_t = ss.sinkhorn_softmax_fwd_plain(x, iters, final_row)
        r = ss.num_vecs(iters, final_row, True)
        assert vecs_t.shape == (logits.size // (nr * nc), r, nr)
        np.testing.assert_allclose(vecs_t.numpy(), np.asarray(vecs_j)[:, :r, :nr], **VALUES)
    else:
        _, va_j, vb_j = jx.ss._rect_fwd_impl(s, iters, final_row, True, want_vecs=True)
        _, va_t, vb_t = ss.sinkhorn_softmax_rect_fwd_plain(x, iters, final_row)
        np.testing.assert_allclose(va_t.numpy(), np.asarray(va_j)[:, :, :nr], **VALUES)
        np.testing.assert_allclose(vb_t.numpy(), np.asarray(vb_j)[:, :, :nc], **VALUES)


def test_robust_softmax_takes_the_two_functions(monkeypatch):
    """``ops.robust_softmax`` on CPU logits: a square shape goes through
    ``SinkhornSoftmax``, a rectangular one through ``SinkhornSoftmaxRect``;
    a 1×N shape, a reduction over another axis, float16 logits and plain
    softmax take neither."""
    calls = []
    for name in ("SinkhornSoftmax", "SinkhornSoftmaxRect"):
        fn = getattr(ss, name)
        real = fn.apply
        monkeypatch.setattr(fn, "apply", lambda x, *a, _n=name, _r=real: (
            calls.append((_n, tuple(x.shape))) or _r(x, *a)))
    ops.robust_softmax(torch.randn(2, 3, 9, 9), robust=True)
    ops.robust_softmax(torch.randn(2, 3, 4, 9), robust=True)
    assert calls == [("SinkhornSoftmax", (2, 3, 9, 9)), ("SinkhornSoftmaxRect", (2, 3, 4, 9))]
    calls.clear()
    ops.robust_softmax(torch.randn(2, 3, 1, 49), robust=True)
    ops.robust_softmax(torch.randn(2, 3, 9, 9), robust=True, axis=-2)
    ops.robust_softmax(torch.randn(2, 3, 9, 9).half(), robust=True)
    ops.robust_softmax(torch.randn(2, 3, 9, 9), robust=False)
    assert calls == []


@pytest.mark.parametrize("shape", [(2, 3, 11, 11), (2, 3, 6, 11)])
def test_plain_versions_agree_with_the_vector_form(shape):
    """The plain versions compute the function of the vector form that
    shapes outside the gate take: softmax, then the rewrites of
    ``sinkhorn_normalize``."""
    logits = torch.randn(shape)
    want = ops.sinkhorn_normalize(torch.softmax(logits, -1), 3, True)
    torch.testing.assert_close(ops.sinkhorn_attention(logits), want, atol=1e-6, rtol=1e-5)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain versions: no kernel is built or
    launched."""
    ss.launches.reset()
    ss.launches_rect.reset()
    for shape in [(2, 2, 7, 7), (2, 2, 5, 7)]:
        x = torch.randn(shape, requires_grad=True)
        ops.robust_softmax(x, robust=True).sum().backward()
    assert (ss.launches.fwd, ss.launches.bwd, ss.launches_rect.fwd,
            ss.launches_rect.bwd) == (0, 0, 0, 0)


@pytest.mark.parametrize("shape,iters,square,rect", [
    ((256, 8, 49, 196), 3, False, True),     # LeViT-128S subsample 0
    ((256, 16, 16, 49), 3, False, True),     # LeViT-128S subsample 1
    ((64, 12, 16, 49), 3, False, True),      # LeViT-256 subsample 1
    ((128, 8, 197, 197), 3, True, False),    # deepvit
    ((64, 3, 196, 196), 8, True, False),     # nest_tiny's N, 8 iterations
    ((8, 640, 640), 3, True, False),         # the largest square: a scratch slot
    ((8, 641, 641), 3, False, False),        # above MAX_N
    ((8, 33, 640), 3, False, True),
    ((8, 1, 49), 3, False, False),           # a single query row
    ((8, 49, 49), 9, False, False),          # more than MAX_ITERS
    ((49,), 3, False, False),
])
def test_gate(shape, iters, square, rect):
    assert ss.sinkhorn_softmax_supported(shape, iters) is square
    assert ss.sinkhorn_softmax_rect_supported(shape, iters) is rect
    assert ss.sinkhorn_softmax_supported(shape, iters, torch.float16) is False


def test_matrix_in_shared_memory_up_to_about_220():
    """The shared-memory plan: LeViT's matrices live in shared memory, a
    square N above ~220 in a global scratch slot."""
    assert ss._matrix_in_smem(196, 196, 8)
    assert ss._matrix_in_smem(197, 197, 3)
    assert ss._matrix_in_smem(49, 196, 3)
    assert not ss._matrix_in_smem(257, 257, 3)
    assert not ss._matrix_in_smem(640, 640, 1)


def test_cuda_wrapper_refuses_cpu_tensor():
    x = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.sinkhorn_softmax_fwd_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.sinkhorn_softmax_rect_fwd_cuda(torch.zeros(1, 4, 5))


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(logits, g, iters, final_row):
    """(kernel, plain) results: (out, residual rows..., ds)."""
    if _square(logits.shape):
        out_k, vecs_k = ss.sinkhorn_softmax_fwd_cuda(logits, iters, final_row)
        ds_k = ss.sinkhorn_softmax_bwd_cuda(logits, g, vecs_k, iters, final_row)
        out_p, vecs_p = ss.sinkhorn_softmax_fwd_plain(logits, iters, final_row)
        ds_p = ss.sinkhorn_softmax_bwd_plain(logits, g, vecs_p, iters, final_row)
        got, want = (out_k, vecs_k, ds_k), (out_p, vecs_p, ds_p)
    else:
        out_k, va_k, vb_k = ss.sinkhorn_softmax_rect_fwd_cuda(logits, iters, final_row)
        ds_k = ss.sinkhorn_softmax_rect_bwd_cuda(logits, g, va_k, vb_k, iters, final_row)
        out_p, va_p, vb_p = ss.sinkhorn_softmax_rect_fwd_plain(logits, iters, final_row)
        ds_p = ss.sinkhorn_softmax_rect_bwd_plain(logits, g, va_p, vb_p, iters, final_row)
        got, want = (out_k, va_k, vb_k, ds_k), (out_p, va_p, vb_p, ds_p)
    torch.cuda.synchronize()
    return got, want


def _assert_kernel_matches(got, want):
    """float32: atol 1e-4 / rtol 1e-3, the sums run in another order than
    the plain version's and the reverse chain amplifies it. bfloat16 in and
    out, float32 inside: the weights and d logits, of order 1/N for N
    columns, agree to one bf16 ulp (rtol 8e-3, atol 1e-3/N); the float32
    residual rows to 1e-3."""
    bf16 = got[0].dtype == torch.bfloat16
    n = got[0].shape[-1]
    for i, (g, w) in enumerate(zip(got, want)):
        if not bf16:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3, msg=f"output {i}")
        elif 0 < i < len(got) - 1:
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=f"output {i}")
        else:
            torch.testing.assert_close(g.float(), w.float(), atol=1e-3 / n, rtol=8e-3,
                                       msg=f"output {i}")


# small shapes, then the main paths': LeViT-128S's subsample logits at
# batch 256 and LeViT-256's at batch 64, CvT-13 stage 3's at batch 128,
# deepvit's square logits at batch 128, 196 × 196 (nest_tiny's N) at 4 and 3
# heads, and matrices held in a global scratch slot
CARD_SHAPES = [(16, 8, 49, 196), (16, 16, 16, 49), (8, 4, 196, 196), (4, 8, 197, 197),
               (8, 3, 33, 7), (8, 3, 45, 45), (4, 257, 257), (2, 300, 96), (2, 2, 640, 640),
               (256, 8, 49, 196), (256, 16, 16, 49), (64, 8, 49, 196), (64, 12, 16, 49),
               (128, 6, 196, 49), (128, 8, 197, 197), (64, 4, 196, 196), (64, 3, 196, 196),
               (4, 2, 640, 640), (8, 300, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, schedule, dtype):
    logits, g = (torch.from_numpy(t).to(cuda, dtype) for t in _inputs(2, shape))
    _assert_kernel_matches(*_kernel_vs_plain(logits, g, *schedule))


@pytest.mark.gpu
@pytest.mark.parametrize("final_row", [False, True])
@pytest.mark.parametrize("iters", [1, 2, 5, 8])
@pytest.mark.parametrize("shape", [(4, 4, 196, 196), (4, 8, 49, 196), (2, 300, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_at_every_iteration_count(cuda, shape, iters, final_row):
    """The gate takes 1 to 8 iterations: the counts the schedules above do
    not reach, float32, in shared memory and in a scratch slot."""
    logits, g = (torch.from_numpy(t).to(cuda) for t in _inputs(5, shape))
    _assert_kernel_matches(*_kernel_vs_plain(logits, g, iters, final_row))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 8, 49, 196), (16, 4, 196, 196), (2, 2, 640, 640)])
def test_kernel_repeats_bit_for_bit(cuda, shape):
    """No atomics: two runs give the same bits."""
    logits, g = (torch.from_numpy(t).to(cuda) for t in _inputs(3, shape))
    first = _kernel_vs_plain(logits, g, 3, True)[0]
    again = _kernel_vs_plain(logits, g, 3, True)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 3, 45, 45), (4, 3, 49, 196), (128, 8, 197, 197)])
def test_autograd_on_card_launches_kernels(cuda, shape):
    """``robust_softmax`` on CUDA logits goes through one forward and one
    backward kernel, and agrees with the CPU path, at deepvit's float32
    square logits too (the call deepvit, rvt, nest and cct make, and Swin's
    robust fallback; no ported model makes it yet); every row sums to one
    (the final row norm)."""
    logits, g = _inputs(4, shape)
    x = torch.from_numpy(logits).requires_grad_(True)
    want = ops.robust_softmax(x, robust=True)
    want.backward(torch.from_numpy(g))
    counts = ss.launches if _square(shape) else ss.launches_rect
    counts.reset()
    xc = torch.from_numpy(logits).to(cuda).requires_grad_(True)
    out = ops.robust_softmax(xc, robust=True)
    out.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert (counts.fwd, counts.bwd) == (1, 1)
    assert (out.detach().sum(-1) - 1).abs().max().item() <= 1e-4
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.detach().numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(xc.grad.cpu().numpy(), x.grad.numpy(), atol=1e-4, rtol=1e-3)
