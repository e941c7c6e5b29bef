"""The port's fused q/k/v attention against the JAX package's Pallas kernel
(``ops/pallas/sinkhorn_attention.py::fused_attention``).

On the CPU the port runs its plain PyTorch versions (the kernels' algorithm
in ``ops/cuda/plain.py``, the hand-derived backward from the residual
rows); the JAX side runs ``fused_attention`` in interpret mode, as
``tests/test_ops.py`` does, on the same numpy inputs and upstream gradient:
vanilla and three Sinkhorn schedules, N of 16, 50, 64 and 100 (50 and 100
ragged: JAX pads them to 128), D of 8, 16 and 32, and DV ≠ D. Tolerances,
float32: out, dq, dk, dv atol and rtol 5e-5; the residual rows rtol 5e-5
(the a- and b-vectors run up to N).

The ``gpu`` cases compare the CUDA kernels with the plain versions on the
card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fused_attention.py -m gpu
"""

import functools
import types
import unittest.mock as mock

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch import ops
from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa

torch.set_num_threads(1)

# (robust, iters, final_row): vanilla, the SinkhornAttention schedule, the
# vendored-MHA schedule, and 4 iterations with a final row norm
MODES = [(False, 3, True), (True, 3, True), (True, 4, False), (True, 4, True)]
TOL = dict(atol=5e-5, rtol=5e-5)
# (b, h, n, d, dv): every N at D = 8 (MobileViT's head width), D = 16 and 32
# at the ragged N, and DV ≠ D
SHAPES = ([(2, 2, n, 8, 8) for n in (16, 50, 64, 100)]
          + [(1, 2, 50, 16, 16), (1, 2, 100, 32, 32), (2, 1, 64, 8, 24)])


def _ids(s):
    return "x".join(map(str, s))


def _mode_id(m):
    return f"{m[1]}-{int(m[2])}" if m[0] else "vanilla"


def _inputs(seed, shape, dtype=np.float32):
    """q, k, v and the upstream gradient from a seed."""
    b, h, n, d, dv = shape
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, n, d)).astype(dtype) for _ in range(2))
    v, g = (rng.standard_normal((b, h, n, dv)).astype(dtype) for _ in range(2))
    return q, k, v, g


def _interpreted(pallas_call):
    @functools.wraps(pallas_call)
    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    return wrapper


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy, the Pallas kernel module (with
    ``interpret``, a context that runs its pallas_call in interpret mode)
    and the JAX package's attention module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops import attention as jattn
    from noise_robust_vit_tpu.ops.pallas import sinkhorn_attention as pk

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, pk=pk, attn=jattn,
        interpret=lambda: mock.patch.object(pk.pl, "pallas_call", _interpreted(pk.pl.pallas_call)))


def _jax_vjp(jx, q, k, v, g, scale, robust, iters, final_row):
    """out and (dq, dk, dv) of the interpret-mode kernel."""
    with jx.interpret():
        out, vjp = jx.jax.vjp(
            lambda a, b, c: jx.pk.fused_attention(a, b, c, scale=scale, robust=robust,
                                                  sinkhorn_iters=iters,
                                                  final_row_norm=final_row),
            *map(jx.jnp.asarray, (q, k, v)))
        grads = vjp(jx.jnp.asarray(g))
    return np.asarray(out), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_matches_jax_kernel(jx, shape, mode):
    """Forward and dq, dk, dv of the plain versions (through
    ``FusedAttention`` on CPU tensors) against ``jax.vjp`` of the
    interpret-mode kernel."""
    robust, iters, final_row = mode
    q, k, v, g = _inputs(0, shape)
    scale = shape[3] ** -0.5
    out_j, grads_j = _jax_vjp(jx, q, k, v, g, scale, robust, iters, final_row)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.FusedAttention.apply(*args, scale, robust, iters, final_row)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), out_j, **TOL)
    for name, a, w in zip("qkv", args, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[-1]], ids=_ids)
def test_plain_residuals_match_jax_kernel(jx, shape, mode):
    """The residual rows (a-rows, b-rows, lse; lse alone when vanilla) are
    the JAX kernel's stack without its padding."""
    robust, iters, final_row = mode
    b, h, n, d, dv = shape
    q, k, v, _ = _inputs(1, shape)
    with jx.interpret():
        _, vecs_j = jx.pk._fused_attention_impl(*map(jx.jnp.asarray, (q, k, v)), d ** -0.5,
                                                robust, iters, final_row, want_vecs=True)
    _, vecs = fa.fused_attention_fwd_plain(
        *(torch.from_numpy(a).reshape(b * h, n, -1) for a in (q, k, v)), d ** -0.5, robust,
        iters, final_row)
    assert vecs.shape == (b * h, fa.num_vecs(iters, final_row, robust), n)
    want = np.asarray(vecs_j).reshape(b * h, -1, vecs_j.shape[-1])[:, :, :n]
    np.testing.assert_allclose(vecs.numpy(), want, atol=1e-6, rtol=5e-5)


def test_bf16_inputs_match_jax_kernel(jx):
    """bfloat16 q, k, v in, bfloat16 out, float32 math: the plain version
    and the JAX kernel round the same float32 result, so they agree to one
    bf16 ulp (8e-3 relative)."""
    shape = (2, 4, 64, 8, 8)
    q, k, v, _ = _inputs(2, shape)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    with jx.interpret():
        out_j = jx.pk.fused_attention(*(jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16)
                                        for t in (qt, kt, vt)), robust=True)
    out = ops.fused_attention(qt, kt, vt, robust=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32), atol=1e-3,
                               rtol=8e-3)


def test_dot_product_attention_takes_it_when_robust(monkeypatch):
    """``ops.dot_product_attention`` sends a robust call with no bias or mask
    to ``FusedAttention`` and gives what the vector form gives; vanilla,
    masked and biased calls stay on the vector form."""
    calls = []
    real = fa.FusedAttention.apply
    monkeypatch.setattr(fa.FusedAttention, "apply",
                        lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, (2, 4, 16, 8, 8)))
    out = ops.dot_product_attention(q, k, v, robust=True)
    assert calls == [(2, 4, 16, 8)]
    for kw in ({"robust": False}, {"robust": True, "mask": torch.ones(16, 16, dtype=bool)},
               {"robust": True, "bias": torch.zeros(16, 16)}):
        ops.dot_product_attention(q, k, v, **kw)
    assert len(calls) == 1
    monkeypatch.setattr(ops.attention, "fused_dispatch", lambda *a, **kw: False)
    want = ops.dot_product_attention(q, k, v, robust=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-6, rtol=2e-5)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain versions: no kernel is built or launched."""
    fa.launches.reset()
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(4, (1, 2, 33, 8, 8)))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    ops.fused_attention(*leaves, robust=True).backward(g)
    assert (fa.launches.fwd, fa.launches.bwd) == (0, 0)
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("args,ok", [
    ((256, 8, 8, 3, True), True),      # MobileViT-XS stage 1
    ((64, 8, 8, 3, True), True),       # stage 2
    ((16, 8, 8, 3, True), True),       # stage 3
    ((1, 4, 4, 3, True), True),        # one row
    ((1150, 8, 8, 3, True), True),     # the longest rows at D = 8, 3 iterations
    ((1200, 8, 8, 3, True), False),    # beyond shared memory
    ((1200, 8, 8, 3, False), True),    # vanilla keeps no chain vectors
    ((256, 8, 8, 8, True), True),      # 8 iterations
    ((256, 8, 8, 9, True), False),     # more than 8
    ((256, 8, 8, 0, True), False),
    ((256, 8, 8, 0, False), True),     # vanilla ignores the iterations
    ((64, 32, 32, 3, True), True),
    ((64, 64, 64, 3, True), False),    # wider than 32
    ((64, 8, 40, 3, True), False),
    ((64, 6, 8, 3, True), False),      # not a multiple of 4
    ((0, 8, 8, 3, True), False),       # no rows
])
def test_gate(args, ok):
    """D and DV from 4 to 32 in steps of 4, 1 to 8 iterations when robust,
    and a block's items within one block's shared memory."""
    assert fa.fused_attention_supported(*args) is ok
    assert fa.fused_attention_supported(*args, dtype=torch.float16) is False


def test_threads_per_item():
    """The least power of two ≥ N threads serve an item, at most 256: 16
    items a block at N = 16, 4 at 64, 1 at 256 and above."""
    assert [fa._threads_per_item(n) for n in (1, 16, 50, 64, 100, 256, 300)] == \
        [1, 16, 64, 64, 128, 256, 256]


# (q shape, k shape, v shape, bias, mask, robust): the JAX refusals and the
# port's own gate
DISPATCH = [
    ((512, 4, 256, 8), None, None, False, False, True),    # MobileViT-XS stage 1
    ((512, 4, 64, 8), None, None, False, False, True),
    ((512, 4, 16, 8), None, None, False, False, True),
    ((512, 4, 256, 8), None, None, False, False, False),   # vanilla never
    ((2, 4, 256, 8), None, None, True, False, True),       # a bias
    ((2, 4, 256, 8), None, None, False, True, True),       # a mask
    ((2, 4, 1, 8), (2, 4, 17, 8), None, False, False, True),  # CaiT's CLS row
    ((2, 2, 1536, 8), None, None, False, False, True),     # JAX's widest, the port's smem refuses
    ((2, 2, 1537, 8), None, None, False, False, True),     # beyond JAX's 1536
    ((2, 2, 16, 64), None, None, False, False, True),      # JAX yes, the port's D ≤ 32 no
    ((2, 2, 16, 300), None, None, False, False, True),     # beyond JAX's 256
    ((2, 2, 50, 16), None, None, False, False, True),
    ((2, 2, 16, 8), None, (2, 2, 16, 24), False, False, True),  # DV ≠ D
]


@pytest.mark.parametrize("case", DISPATCH, ids=lambda c: f"{_ids(c[0])}-{c[3]:d}{c[4]:d}{c[5]:d}")
def test_dispatch_matches_jax(jx, case):
    """``fused_dispatch`` takes a call exactly when the JAX package, on the
    TPU, would run its fused kernel (``pallas_dispatch`` robust only, and
    ``fused_attention`` not refusing) and the port's kernel gate takes the
    shape."""
    q_shape, k_shape, v_shape, bias, mask, robust = case
    k_shape, v_shape = k_shape or q_shape, v_shape or k_shape or q_shape
    jnp = jx.jnp
    with mock.patch.object(jx.attn, "use_pallas_default", lambda: True):
        jax_policy = jx.attn.pallas_dispatch(robust, q_shape[-2])
    structs = [jx.jax.ShapeDtypeStruct(s, jnp.float32) for s in (q_shape, k_shape, v_shape)]
    extra = {}
    if bias:
        extra["bias"] = jx.jax.ShapeDtypeStruct(q_shape[-2:-1] * 2, jnp.float32)
    if mask:
        extra["mask"] = jx.jax.ShapeDtypeStruct(q_shape[-2:-1] * 2, jnp.bool_)
    taken = jx.jax.eval_shape(
        lambda q, k, v, kw: jx.pk.fused_attention(q, k, v, robust=robust, **kw),
        *structs, extra) is not None
    want = (jax_policy and taken
            and fa.fused_attention_supported(q_shape[-2], q_shape[-1], v_shape[-1]))
    assert ops.fused_dispatch(robust, q_shape, k_shape, v_shape, bias, mask) is want
    assert jax_policy is robust


def test_cuda_wrapper_refuses_cpu_tensor():
    q, k, v, _ = (torch.from_numpy(a)[0] for a in _inputs(5, (1, 1, 8, 8, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.fused_attention_fwd_cuda(q, k, v, 0.5, True)


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(q, k, v, g, robust, iters, final_row):
    """(kernel, plain) results: (out, vecs, dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    got = fa.fused_attention_fwd_cuda(q, k, v, scale, robust, iters, final_row)
    got = (*got, *fa.fused_attention_bwd_cuda(q, k, v, g, got[1], scale, robust, iters,
                                              final_row))
    want = fa.fused_attention_fwd_plain(q, k, v, scale, robust, iters, final_row)
    want = (*want, *fa.fused_attention_bwd_plain(q, k, v, g, want[1], scale, robust, iters,
                                                 final_row))
    torch.cuda.synchronize()
    return got, want


def assert_kernel_matches(got, want):
    """float32: out, dq, dk, dv atol 1e-4 / rtol 1e-3 (the sums run in
    another order and the reverse chain amplifies it), the residual rows
    rtol 1e-3; bfloat16 q, k, v (math in float32): out, dq, dk, dv atol and
    rtol 2e-2 (one bf16 rounding of values of order one), the float32
    residual rows atol and rtol 1e-3."""
    bf16 = got[0].dtype == torch.bfloat16
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1:
            torch.testing.assert_close(a, b, atol=1e-3 if bf16 else 1e-4, rtol=1e-3,
                                       msg="vecs")
        elif bf16:
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2,
                                       msg=f"output {i}")
        else:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=f"output {i}")


def card_inputs(cuda, seed, shape, dtype=torch.float32):
    """[K, N, D] q, k and [K, N, DV] v, g on the card."""
    kb, n, d, dv = shape
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((kb, n, d), dtype=np.float32) for _ in range(2))
    v, g = (rng.standard_normal((kb, n, dv), dtype=np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, g))


# MobileViT-XS's three stages at batch 128 (2048 items), ragged N, DV ≠ D,
# the widest heads, one row, and rows beyond 256 threads
CARD_SHAPES = [(2048, 256, 8, 8), (2048, 64, 8, 8), (2048, 16, 8, 8), (6, 50, 16, 16),
               (5, 100, 8, 24), (3, 300, 32, 32), (7, 1, 4, 4), (2, 1000, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=_ids)
def test_kernel_matches_plain(cuda, shape, mode, dtype):
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 6, shape, dtype), *mode))


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 8])
def test_kernel_matches_plain_at_short_and_long_schedules(cuda, iters):
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 7, (16, 64, 8, 8)), True, iters,
                                            False))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES[:3], ids=_ids)
def test_kernel_repeats_bit_for_bit(cuda, shape):
    """No atomics: every sum runs in a fixed order inside one thread, so two
    runs give the same bits."""
    inputs = card_inputs(cuda, 8, shape, torch.bfloat16)
    first = _kernel_vs_plain(*inputs, True, 3, True)[0]
    again = _kernel_vs_plain(*inputs, True, 3, True)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_autograd_on_card_launches_kernels(cuda):
    """``ops.fused_attention`` on CUDA tensors goes through one forward and
    one backward launch, and agrees with the CPU path."""
    q, k, v, g = _inputs(9, (2, 4, 64, 8, 8))
    cpu = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    want = ops.fused_attention(*cpu, robust=True)
    want.backward(torch.from_numpy(g))
    fa.launches.reset()
    card = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (q, k, v)]
    out = ops.fused_attention(*card, robust=True)
    out.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert (fa.launches.fwd, fa.launches.bwd) == (1, 1)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.detach().numpy(), atol=1e-4,
                               rtol=1e-3)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-3)
