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

The kernels have two branches, chosen before the call by
``fused_branch``: the resident kernels (bf16, D = DV = 8, N ≤ 256) and the
recompute kernels (every other shape the gate takes). The CPU cases hold the
rule at the edges of its gate; the ``gpu`` cases compare either branch's
kernels with the plain versions on the card and skip where there is none. JAX is imported only by the tests that
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


@pytest.mark.parametrize("mode", MODES[:2], ids=_mode_id)
@pytest.mark.parametrize("n", [256, 64, 16])
def test_plain_matches_jax_kernel_at_mobile_vit_stages(jx, n, mode):
    """At MobileViT-XS's three stage lengths (4 heads of 8, one image), the
    plain versions, which the resident kernels are held against on the card,
    against the interpret-mode kernel: out, dq, dk, dv at 5e-5."""
    robust, iters, final_row = mode
    shape = (1, 4, n, 8, 8)
    q, k, v, g = _inputs(11, shape)
    out_j, grads_j = _jax_vjp(jx, q, k, v, g, 8 ** -0.5, robust, iters, final_row)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.FusedAttention.apply(*args, 8 ** -0.5, robust, iters, final_row)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), out_j, **TOL)
    for name, a, w in zip("qkv", args, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), w, err_msg=f"d{name}", **TOL)


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


BF16, F32 = torch.bfloat16, torch.float32
# (n, d, dv, dtype, robust, iters, branch): the resident branch's rule at the
# edges of its gate
BRANCH = [
    (256, 8, 8, BF16, True, 3, "resident"),      # MobileViT-XS stage 1
    (64, 8, 8, BF16, True, 3, "resident"),       # stage 2
    (16, 8, 8, BF16, True, 3, "resident"),       # stage 3
    (1, 8, 8, BF16, True, 3, "resident"),        # one row
    (128, 8, 8, BF16, True, 3, "resident"),      # the last N one block holds
    (129, 8, 8, BF16, True, 3, "resident"),      # the first a cluster of two holds
    (257, 8, 8, BF16, True, 3, "recompute"),     # beyond the resident rows
    (256, 16, 16, BF16, True, 3, "recompute"),   # wider heads
    (256, 8, 16, BF16, True, 3, "recompute"),    # DV ≠ 8
    (256, 16, 8, BF16, True, 3, "recompute"),    # D ≠ 8
    (256, 8, 8, F32, True, 3, "recompute"),      # float32
    (256, 8, 8, F32, False, 3, "recompute"),
    (256, 8, 8, BF16, False, 3, "resident"),     # vanilla
    (257, 8, 8, BF16, False, 3, "recompute"),
    (256, 8, 8, BF16, False, 0, "resident"),     # vanilla ignores the iterations
    (256, 8, 8, BF16, True, 1, "resident"),
    (256, 8, 8, BF16, True, 8, "resident"),
    (257, 8, 8, BF16, True, 8, "recompute"),
    (16, 8, 8, BF16, True, 8, "resident"),
    (256, 8, 8, BF16, True, 9, "recompute"),     # beyond 8 (the gate refuses it too)
]


@pytest.mark.parametrize("case", BRANCH, ids=lambda c: (
    f"n{c[0]}-d{c[1]}-dv{c[2]}-{str(c[3]).split('.')[1]}-"
    + (f"r{c[5]}" if c[4] else "vanilla")))
def test_branch_rule(case):
    """bf16 at D = DV = 8 and N ≤ 256 takes the resident kernels, both modes,
    1 to 8 iterations; every other shape the recompute kernels."""
    n, d, dv, dtype, robust, iters, want = case
    assert fa.fused_branch(n, d, dv, dtype, robust, iters) == want


@pytest.mark.parametrize("iters", range(1, 9))
def test_resident_takes_every_n_up_to_256(iters):
    """The shared-memory formulas (csrc fwd_smem_bytes, bwd_smem_bytes,
    mirrored) keep every N from 1 to 256 within a block, robust at every
    schedule and vanilla; the branch stops at N = 256 (a cluster of two
    blocks of 128 rows)."""
    for n in range(1, 257):
        assert fa._resident_fits(n, 8, 8, True, iters)
        assert fa._resident_fits(n, 8, 8, False, iters)
    assert not fa._resident_fits(257, 8, 8, True, iters)
    assert fa._res_items(16) == 8 and fa._res_items(64) == 2 and fa._res_items(256) == 1


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


def _kernel_vs_plain(q, k, v, g, robust, iters, final_row, branch=None):
    """(kernel, plain) results: (out, vecs, dq, dk, dv); the kernels of
    ``branch`` (the rule's by default)."""
    scale = q.shape[-1] ** -0.5
    got = fa.fused_attention_fwd_cuda(q, k, v, scale, robust, iters, final_row, branch)
    got = (*got, *fa.fused_attention_bwd_cuda(q, k, v, g, got[1], scale, robust, iters,
                                              final_row, branch))
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
    """One launch each way, on the branch the rule picks, none on the other."""
    for c in (fa.launches_resident, fa.launches_recompute):
        c.reset()
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 6, shape, dtype), *mode))
    rule = fa.fused_branch(*shape[1:], dtype, mode[0], mode[1])
    for name, c in (("resident", fa.launches_resident), ("recompute", fa.launches_recompute)):
        assert (c.fwd, c.bwd) == ((1, 1) if name == rule else (0, 0)), name


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 8])
def test_kernel_matches_plain_at_short_and_long_schedules(cuda, iters):
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 7, (16, 64, 8, 8)), True, iters,
                                            False))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES[:3], ids=_ids)
def test_kernel_repeats_bit_for_bit(cuda, shape):
    """No atomics: every sum runs in a fixed order inside one thread, so two
    runs give the same bits, bf16 (the resident kernels) and float32 (the
    recompute kernels)."""
    for dtype in (torch.bfloat16, torch.float32):
        inputs = card_inputs(cuda, 8, shape, dtype)
        first = _kernel_vs_plain(*inputs, True, 3, True)[0]
        again = _kernel_vs_plain(*inputs, True, 3, True)[0]
        assert all(torch.equal(a, b) for a, b in zip(first, again)), dtype


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


# --------------------------------------------------------------------------
# on the card: the two branches
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES[:2], ids=_mode_id)
@pytest.mark.parametrize("shape", CARD_SHAPES[:3], ids=_ids)
def test_resident_branch_matches_plain(cuda, shape, mode):
    """At MobileViT-XS's three stages, bf16: the rule picks the resident
    kernels, which launch (and no recompute kernel) and agree with the plain
    versions to one bf16 ulp."""
    inputs = card_inputs(cuda, 12, shape, torch.bfloat16)
    assert fa.fused_branch(shape[1], 8, 8, torch.bfloat16, mode[0], mode[1]) == "resident"
    fa.launches_resident.reset()
    fa.launches_recompute.reset()
    assert_kernel_matches(*_kernel_vs_plain(*inputs, *mode))
    assert (fa.launches_resident.fwd, fa.launches_resident.bwd) == (1, 1)
    assert (fa.launches_recompute.fwd, fa.launches_recompute.bwd) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES[:2], ids=_mode_id)
@pytest.mark.parametrize("shape", CARD_SHAPES[:3], ids=_ids)
def test_resident_branch_repeats_bit_for_bit(cuda, shape, mode):
    """Column sums over an item's warps (and a cluster's two blocks) run in a
    fixed order: two runs give the same bits."""
    inputs = card_inputs(cuda, 13, shape, torch.bfloat16)
    first = _kernel_vs_plain(*inputs, *mode, branch="resident")[0]
    again = _kernel_vs_plain(*inputs, *mode, branch="resident")[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 8])
@pytest.mark.parametrize("n", [1, 50, 129, 200])
def test_resident_branch_at_ragged_n(cuda, n, iters):
    """Ragged N (rows and columns masked; at 129 and 200 a cluster's second
    block holds a partial band) and the shortest and longest schedules."""
    inputs = card_inputs(cuda, 14, (5, n, 8, 8), torch.bfloat16)
    assert_kernel_matches(*_kernel_vs_plain(*inputs, True, iters, iters == 1, "resident"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES[:3], ids=_ids)
def test_recompute_branch_forced_in_bf16(cuda, shape):
    """The recompute kernels still take bf16 at the stage shapes when asked."""
    inputs = card_inputs(cuda, 15, shape, torch.bfloat16)
    assert_kernel_matches(*_kernel_vs_plain(*inputs, True, 3, True, "recompute"))


@pytest.mark.gpu
def test_branch_rule_matches_library(cuda):
    """The Python rule and the library's (nrv_fused_resident_fits) agree."""
    from noise_robust_vit_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for n in range(1, 301):
        for d, dv in ((8, 8), (8, 16), (16, 8), (4, 4)):
            for robust, iters in ((False, 3), (True, 1), (True, 3), (True, 8), (True, 9)):
                assert bool(lib.nrv_fused_resident_fits(n, d, dv, int(robust), iters)) == \
                    fa._resident_fits(n, d, dv, robust, iters), (n, d, dv, robust, iters)


@pytest.mark.gpu
def test_resident_branch_refuses_what_it_does_not_take(cuda):
    for shape, dtype in (((4, 64, 8, 8), torch.float32), ((4, 64, 16, 16), torch.bfloat16),
                         ((4, 300, 8, 8), torch.bfloat16)):
        q, k, v, _ = card_inputs(cuda, 16, shape, dtype)
        with pytest.raises(ValueError, match="resident branch"):
            fa.fused_attention_fwd_cuda(q, k, v, 0.35, True, branch="resident")


@pytest.mark.gpu
@pytest.mark.parametrize("robust", [True, False])
def test_mobile_vit_xs_launches_only_the_resident_branch(cuda, robust):
    """A robust MobileViT-XS @256 bf16 forward and backward launches the
    resident kernels 9 times each way (its 9 transformer layers) and the
    recompute kernels never; a vanilla one launches neither."""
    from noise_robust_vit_tpu_torch import create_model

    model = create_model("mobile_vit_xs", num_classes=10, image_size=256, robust=robust,
                         dtype=torch.bfloat16, device=cuda, seed=0)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 256, 256, 3), dtype=np.float32)).to(cuda, torch.bfloat16)
    for c in (fa.launches, fa.launches_resident, fa.launches_recompute):
        c.reset()
    model(x).float().square().sum().backward()
    torch.cuda.synchronize()
    want = (9, 9) if robust else (0, 0)
    assert (fa.launches_resident.fwd, fa.launches_resident.bwd) == want
    assert (fa.launches_recompute.fwd, fa.launches_recompute.bwd) == (0, 0)
    assert (fa.launches.fwd, fa.launches.bwd) == want
