"""The port's streaming q/k/v-interface Sinkhorn attention against the JAX
package's Pallas kernel (``ops/pallas/streaming_sinkhorn.py``).

On the CPU the port runs its plain PyTorch versions (the sweeps over query
tiles, the hand-derived backward from the residual vectors); the JAX side
runs ``streaming_attention`` in interpret mode, as
``tests/test_streaming_sinkhorn.py`` does, on the same numpy inputs and
upstream gradient, at that file's shapes and schedules. Tolerances, float32,
the JAX suite's own: out atol 5e-6 / rtol 1e-5, dq, dk, dv atol and rtol
2e-5; the residual vectors, which the JAX suite does not compare, rtol 2e-5
(the a- and b-vectors run up to the number of keys or queries).

``splits=`` makes the plain versions mirror the split kernels' order of
sums (per-split column partials added in split order, the [M, D] gradients
key-major); that mirror is held against the JAX kernel at the same
tolerances, and against the unsplit plain versions within rounding (atol
1e-6, rtol 1e-5).

The ``gpu`` cases compare the CUDA kernels of both branches (``split``:
bf16, D = 64; ``tile``: the rest) with the plain versions on the card and
skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_streaming_attention.py -m gpu
"""

import types

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch import ops
from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa

torch.set_num_threads(1)

# tests/test_streaming_sinkhorn.py:31-38: square, rectangular both ways,
# several query tiles, unaligned everything; (b, h, n, m, d)
SHAPES = [(2, 2, 37, 21, 16), (1, 1, 300, 100, 32), (2, 1, 64, 64, 8), (1, 2, 260, 130, 24),
          (2, 1, 49, 196, 16)]
SCHEDULES = [(3, True), (4, False), (1, True), (2, False)]
OUT = dict(atol=5e-6, rtol=1e-5)
GRADS = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, shape, dtype=np.float32):
    """q, k, v and the upstream gradient from a seed."""
    b, h, n, m, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(dtype)
    k, v = (rng.standard_normal((b, h, m, d)).astype(dtype) for _ in range(2))
    return q, k, v, rng.standard_normal((b, h, n, d)).astype(np.float32)


def _vector_form(q, k, v, scale, iters, final_row):
    """sinkhorn(softmax(scale·q·kᵀ)) · v through the port's vector form."""
    attn = ops.sinkhorn_attention(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale,
                                  num_iters=iters, final_row_norm=final_row)
    return torch.matmul(attn, v.float())


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy, the Pallas kernel module and the
    JAX package's ops."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu import ops as jops
    from noise_robust_vit_tpu.ops.pallas import streaming_sinkhorn as jss

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ss=jss, ops=jops)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel(jx, shape, schedule):
    """Forward and dq, dk, dv of the plain versions (through
    ``StreamingAttention`` on CPU tensors) against ``jax.vjp`` of the
    interpret-mode kernel."""
    iters, final_row = schedule
    q, k, v, g = _inputs(0, shape)
    scale = shape[-1] ** -0.5
    out_j, vjp = jx.jax.vjp(
        lambda a, b, c: jx.ss.streaming_attention(a, b, c, scale, iters, final_row, True),
        *map(jx.jnp.asarray, (q, k, v)))
    grads_j = vjp(jx.jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = sa.StreamingAttention.apply(*args, scale, iters, final_row)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **OUT)
    for name, a, w in zip("qkv", args, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), err_msg=f"d{name}", **GRADS)


@pytest.mark.parametrize("schedule", SCHEDULES[:2], ids=["3-1", "4-0"])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3]], ids=lambda s: "x".join(map(str, s)))
def test_plain_residuals_match_jax_kernel(jx, shape, schedule):
    """``av`` (lse, then the a-vectors) and ``bv`` (the b-vectors) are the
    JAX kernel's row-major residuals without its padding."""
    iters, final_row = schedule
    b, h, n, m, d = shape
    q, k, v, _ = _inputs(1, shape)
    _, av_j, bv_j = jx.ss._stream_fwd_impl(*map(jx.jnp.asarray, (q, k, v)), d ** -0.5, iters,
                                           final_row, True, want_vecs=True)
    _, av, bv = sa.streaming_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), d ** -0.5,
                                                 iters, final_row)
    assert av.shape == (b * h, 1 + max(iters - 1, 0) + final_row, n)
    assert bv.shape == (b * h, iters, m)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j)[:, :, :n], atol=1e-6, rtol=2e-5)
    np.testing.assert_allclose(bv.numpy(), np.asarray(bv_j)[:, :, :m], atol=1e-6, rtol=2e-5)


def test_bf16_inputs_match_jax_kernel(jx):
    """bfloat16 q, k, v in, bfloat16 out, float32 math: the port's plain
    version and the JAX kernel round the same float32 result, so they agree
    to one bf16 ulp (8e-3 relative)."""
    shape = (2, 2, 40, 24, 16)
    q, k, v, g = _inputs(2, shape)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    qt, kt, vt = map(to_bf16, (q, k, v))
    out_j = jx.ss.streaming_attention(*(jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16)
                                        for t in (qt, kt, vt)), 16 ** -0.5, 3, True, True)
    out = ops.streaming_attention(qt, kt, vt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32), atol=1e-3,
                               rtol=8e-3)
    want = _vector_form(qt, kt, vt, 16 ** -0.5, 3, True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=1e-2, rtol=8e-3)


@pytest.mark.parametrize("tile", [1, 7, 64])
def test_tiles_and_padding_change_nothing(tile):
    """Query tiles of any size (rows padded to the tile with lse = +BIG,
    keys to a multiple of 8 and masked before the exp) give the one-tile
    numbers, and both the vector form's, forward and backward."""
    shape, (iters, final_row) = (2, 2, 45, 19, 8), (3, True)
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, shape))
    scale = 8 ** -0.5
    one = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row)
    tiled = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row, tile=tile)
    for a, b in zip(one, tiled):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    grads = [sa.streaming_attention_bwd_plain(q, k, v, g, *one[1:], scale, iters, final_row,
                                              tile=t) for t in (None, tile)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = _vector_form(*leaves, scale, iters, final_row)
    want.backward(g)
    torch.testing.assert_close(one[0], want.detach(), **OUT)
    for a, b in zip(grads[0], leaves):
        torch.testing.assert_close(a, b.grad, **GRADS)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain versions: no kernel is built or
    launched."""
    sa.launches.reset()
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(4, (1, 2, 33, 17, 8)))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    ops.streaming_attention(*leaves).backward(g)
    assert (sa.launches.fwd, sa.launches.bwd) == (0, 0)
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("args,ok", [
    ((128, 1, 3136, 784, 64, 3), True),   # CvT-13 stage 1 at 224 px
    ((128, 3, 784, 196, 64, 3), True),    # CvT-13 stage 2
    ((128, 8, 3136, 49, 64, 3), True),    # Twins-SVT small, global stage 1
    ((2, 1, 3136, 784, 64, 8), True),     # 8 iterations
    ((2, 1, 3136, 784, 64, 9), False),    # more than 8
    ((2, 1, 3136, 784, 64, 0), False),
    ((2, 1, 100, 2000, 64, 3), True),     # the widest rows at 16-row tiles
    ((2, 1, 100, 2100, 64, 3), False),    # beyond shared memory
    ((2, 1, 50, 40, 6, 3), False),        # D not a multiple of 4
    ((2, 1, 0, 40, 8, 3), False),         # no queries
])
def test_gate(args, ok):
    """A shared-memory budget for one query tile of full rows and the
    column vectors; N does not count."""
    assert sa.streaming_attention_supported(*args) is ok
    assert sa.streaming_attention_supported(*args, dtype=torch.float16) is False


def test_tile_choice():
    """The largest query tile that fits: 32 rows at CvT stage 1 (784 keys),
    64 at stage 2 (196 keys)."""
    assert sa._tile(784, 64, 3) == 32
    assert sa._tile(196, 64, 3) == 64
    assert sa._tile(2000, 64, 3) == 16
    assert sa._tile(2100, 64, 3) == 0


@pytest.mark.parametrize("args,want", [
    ((True, 128, 1, 3136, 784, 64), True),    # CvT stage 1 streams
    ((True, 128, 3, 784, 196, 64), True),     # stage 2 (784 queries pad to 896 > 640)
    ((True, 128, 6, 196, 49, 64), False),     # stage 3: the rect logits kernels
    ((True, 256, 12, 196, 196, 64), False),   # SimpleViT's 196×196
    ((True, 2, 1, 640, 640, 64), False),      # inside the logits kernels' 640
    ((False, 128, 1, 3136, 784, 64), False),  # vanilla never streams
    ((False, 128, 3, 784, 196, 64), False),
])
def test_dispatch(jx, args, want):
    """The JAX package's policy, with its Pallas kernels switched on (off the
    TPU it never takes them), gives the same answer."""
    assert ops.streaming_dispatch(*args) is want
    try:
        jx.ops.set_use_pallas(True)
        assert jx.ops.streaming_dispatch(*args) is want
    finally:
        jx.ops.set_use_pallas(None)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_mirror_matches_jax_kernel(jx, shape, schedule):
    """The plain versions in the split kernels' order of sums (3 splits of
    the rows) against ``jax.vjp`` of the interpret-mode kernel: out, dq, dk,
    dv at the JAX suite's tolerances."""
    iters, final_row = schedule
    q, k, v, g = _inputs(10, shape)
    scale = shape[-1] ** -0.5
    out_j, vjp = jx.jax.vjp(
        lambda a, b, c: jx.ss.streaming_attention(a, b, c, scale, iters, final_row, True),
        *map(jx.jnp.asarray, (q, k, v)))
    grads_j = vjp(jx.jnp.asarray(g))
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out, av, bv = sa.streaming_attention_fwd_plain(qt, kt, vt, scale, iters, final_row, splits=3)
    grads = sa.streaming_attention_bwd_plain(qt, kt, vt, gt, av, bv, scale, iters, final_row,
                                             splits=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **OUT)
    for name, a, w in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=f"d{name}", **GRADS)


@pytest.mark.parametrize("splits", [1, 3, 7, 5, 40], ids=lambda s: f"splits{s}")
@pytest.mark.parametrize("schedule", SCHEDULES + [(1, False)],
                         ids=lambda s: f"{s[0]}-{int(s[1])}")
def test_splits_change_nothing_but_rounding(schedule, splits):
    """Any number of splits (5 leaves a short last split of 37 rows, 40 one
    row a split and three empty) gives the unsplit plain versions' numbers
    within rounding: out, av, bv, dq, dk, dv."""
    iters, final_row = schedule
    shape = (2, 2, 37, 21, 16)
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(11, shape))
    scale = 16 ** -0.5
    want = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row)
    got = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row, splits=splits)
    want += sa.streaming_attention_bwd_plain(q, k, v, g, *want[1:], scale, iters, final_row)
    got += sa.streaming_attention_bwd_plain(q, k, v, g, *got[1:], scale, iters, final_row,
                                            splits=splits)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5, msg=f"output {i}")


@pytest.mark.parametrize("args,want", [
    ((3136, 784, 64, torch.bfloat16, 3), "split"),   # CvT-13 stage 1
    ((784, 196, 64, torch.bfloat16, 3), "split"),    # CvT-13 stage 2
    ((3136, 64, 64, torch.bfloat16, 3), "split"),    # Twins-SVT-S stage 1 (M = 64)
    ((784, 16, 64, torch.bfloat16, 3), "split"),     # Twins-SVT-S stage 2 (M = 16)
    ((5, 1, 64, torch.bfloat16, 8), "split"),        # one key, 8 iterations
    ((3136, 784, 64, torch.bfloat16, 9), "tile"),    # beyond 8 iterations
    ((3136, 784, 64, torch.float32, 3), "tile"),     # float32
    ((300, 130, 24, torch.bfloat16, 3), "tile"),     # D = 24
    ((300, 130, 32, torch.bfloat16, 3), "tile"),     # D = 32
])
def test_streaming_branch_rule(args, want):
    """The split branch takes bf16 at D = 64 and 1 to 8 iterations, any N
    and M; everything else the gate takes stays on the tile branch."""
    assert sa.streaming_branch(*args) == want


def test_cuda_wrapper_refuses_forced_branch_outside_its_rule():
    """A forced ``branch="split"`` outside the rule raises, in both
    directions, before anything is launched; so does a branch that does
    not exist."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(12, (1, 1, 8, 8, 8)))
    _, av, bv = sa.streaming_attention_fwd_plain(q, k, v, 0.5)
    with pytest.raises(ValueError, match="split branch does not take"):
        sa.streaming_attention_fwd_cuda(q, k, v, 0.5, branch="split")
    with pytest.raises(ValueError, match="split branch does not take"):
        sa.streaming_attention_bwd_cuda(q, k, v, g, av, bv, 0.5, branch="split")
    with pytest.raises(ValueError, match="no branch"):
        sa.streaming_attention_fwd_cuda(q, k, v, 0.5, branch="resident")
    q16, k16, v16 = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(12, (1, 1, 8, 8, 32))[:3])
    with pytest.raises(ValueError, match="split branch does not take"):
        sa.streaming_attention_fwd_cuda(q16, k16, v16, 32 ** -0.5, branch="split")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sa.streaming_attention_fwd_cuda(q16, k16, v16, 32 ** -0.5, branch="tile")


def test_cuda_wrapper_refuses_cpu_tensor():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, (1, 1, 8, 8, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sa.streaming_attention_fwd_cuda(q, k, v, 0.5)


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(q, k, v, g, iters, final_row, branch=None):
    """(kernel, plain) results: (out, av, bv, dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    got = sa.streaming_attention_fwd_cuda(q, k, v, scale, iters, final_row, branch=branch)
    got = (*got, *sa.streaming_attention_bwd_cuda(q, k, v, g, *got[1:], scale, iters, final_row,
                                                  branch=branch))
    want = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row)
    want = (*want, *sa.streaming_attention_bwd_plain(q, k, v, g, *want[1:], scale, iters,
                                                     final_row))
    torch.cuda.synchronize()
    return got, want


def assert_kernel_matches(got, want):
    """float32: out, dq, dk, dv atol 1e-4 / rtol 1e-3 (the sums run in
    another order and the reverse chain amplifies it), the residual vectors
    rtol 1e-3; bfloat16 q, k, v (math in float32): out, dq, dk, dv atol
    2e-2 (one bf16 rounding of values of order one), the float32 residual
    vectors atol and rtol 1e-3."""
    bf16 = got[0].dtype == torch.bfloat16
    for i, (a, b) in enumerate(zip(got, want)):
        if i in (1, 2):
            torch.testing.assert_close(a, b, atol=1e-3 if bf16 else 1e-4, rtol=1e-3,
                                       msg=f"output {i}")
        elif bf16:
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2,
                                       msg=f"output {i}")
        else:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=f"output {i}")


def card_inputs(cuda, seed, shape, dtype=torch.float32):
    q, k, v, g = _inputs(seed, shape)
    return tuple(torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, g))


# CvT stage 1 and 2 at a small batch, both sides ragged, one key, a tall
# Twins-like stage, 16-row tiles
CARD_SHAPES = [(2, 1, 3136, 784, 64), (4, 3, 784, 196, 64), (2, 2, 300, 130, 24),
               (3, 1, 37, 1, 8), (2, 2, 1000, 49, 64), (1, 1, 130, 1900, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, schedule, dtype):
    """One launch each way, on the branch the rule picks, none on the other."""
    for c in (sa.launches_split, sa.launches_tile):
        c.reset()
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 6, shape, dtype), *schedule))
    rule = sa.streaming_branch(*shape[2:], dtype, schedule[0])
    for name, c in (("split", sa.launches_split), ("tile", sa.launches_tile)):
        assert (c.fwd, c.bwd) == ((1, 1) if name == rule else (0, 0)), name


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [5, 8])
def test_kernel_matches_plain_at_long_schedules(cuda, iters):
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 7, (2, 2, 200, 100, 32)), iters,
                                            True))


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit(cuda):
    """No atomics: every column sum and the [M, D] accumulators run in tile
    order inside one block, so two runs give the same bits."""
    inputs = card_inputs(cuda, 8, (4, 3, 784, 196, 64), torch.bfloat16)
    first = _kernel_vs_plain(*inputs, 3, True)[0]
    again = _kernel_vs_plain(*inputs, 3, True)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_autograd_on_card_launches_kernels(cuda):
    """``ops.streaming_attention`` on CUDA tensors goes through one forward
    and one backward launch, and agrees with the CPU path."""
    q, k, v, g = _inputs(9, (2, 2, 700, 90, 32))
    cpu = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    want = ops.streaming_attention(*cpu)
    want.backward(torch.from_numpy(g))
    sa.launches.reset()
    card = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (q, k, v)]
    out = ops.streaming_attention(*card)
    out.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert (sa.launches.fwd, sa.launches.bwd) == (1, 1)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.detach().numpy(), atol=1e-4,
                               rtol=1e-3)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-3)


# CvT-13's stages 1 and 2 and Twins-SVT-S's stage-1 global attention (8
# heads, 3136 queries against 64 subsampled keys) at their batches of 128
# and 16
MAIN_SHAPES = [(128, 1, 3136, 784, 64), (128, 3, 784, 196, 64), (16, 8, 3136, 64, 64)]
# The split branch at CvT-13's stages 1 and 2 (small batch), Twins-SVT-S's
# global stages 1 and 2 (8 heads, 64 and 16 keys), ragged both ways, one key,
# and the main paths
SPLIT_SHAPES = [(2, 1, 3136, 784, 64), (4, 3, 784, 196, 64), (2, 8, 3136, 64, 64),
                (2, 8, 784, 16, 64), (3, 2, 37, 21, 64), (1, 1, 5, 1, 64), *MAIN_SHAPES]
SPLIT_SCHEDULES = [(3, True), (4, False), (1, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", SPLIT_SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_kernels_match_plain(cuda, shape, schedule):
    """bf16: out, dq, dk, dv atol and rtol 2e-2, av and bv 1e-3; one launch
    each way, counted on the split branch; the same bits twice."""
    inputs = card_inputs(cuda, 13, shape, torch.bfloat16)
    sa.launches_split.reset()
    got, want = _kernel_vs_plain(*inputs, *schedule, branch="split")
    assert (sa.launches_split.fwd, sa.launches_split.bwd) == (1, 1)
    assert_kernel_matches(got, want)
    again = _kernel_vs_plain(*inputs, *schedule, branch="split")[0]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", SPLIT_SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_branch_forced_in_bf16(cuda, shape, schedule):
    """The tile kernels still take bf16 at the main paths' shapes when
    asked: one launch each way on the tile branch, none on the split one;
    at CvT-13's stage 1, (3, final), the same bits twice."""
    inputs = card_inputs(cuda, 18, shape, torch.bfloat16)
    for c in (sa.launches_split, sa.launches_tile):
        c.reset()
    got, want = _kernel_vs_plain(*inputs, *schedule, branch="tile")
    assert (sa.launches_tile.fwd, sa.launches_tile.bwd) == (1, 1)
    assert (sa.launches_split.fwd, sa.launches_split.bwd) == (0, 0)
    assert_kernel_matches(got, want)
    if shape == MAIN_SHAPES[0] and schedule == (3, True):
        again = _kernel_vs_plain(*inputs, *schedule, branch="tile")[0]
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", [(5, True), (8, True), (8, False)],
                         ids=["5-1", "8-1", "8-0"])
def test_split_kernels_at_long_schedules(cuda, schedule):
    """Up to 8 iterations: 16 rank-1 terms at (8, final), the most the
    split backward's factor rows hold."""
    assert_kernel_matches(*_kernel_vs_plain(*card_inputs(cuda, 17, (2, 2, 600, 150, 64),
                                                         torch.bfloat16), *schedule,
                                            branch="split"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [SPLIT_SHAPES[0], SPLIT_SHAPES[2]],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_kernels_repeat_bit_for_bit(cuda, shape):
    """No atomics: the column partials are summed in split order, every row
    and key sum by one warp in a fixed order, so two runs give the same
    bits."""
    inputs = card_inputs(cuda, 14, shape, torch.bfloat16)
    first = _kernel_vs_plain(*inputs, 3, True, branch="split")[0]
    again = _kernel_vs_plain(*inputs, 3, True, branch="split")[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_branch,bwd_branch", [("tile", "split"), ("split", "tile")])
@pytest.mark.parametrize("schedule", [(3, True), (4, False)], ids=["3-1", "4-0"])
def test_branches_share_residuals(cuda, fwd_branch, bwd_branch, schedule):
    """Either branch's backward takes the other's forward residuals: the
    gradients match the plain version's."""
    q, k, v, g = card_inputs(cuda, 15, (4, 3, 784, 196, 64), torch.bfloat16)
    scale = 64 ** -0.5
    _, av, bv = sa.streaming_attention_fwd_cuda(q, k, v, scale, *schedule, branch=fwd_branch)
    got = sa.streaming_attention_bwd_cuda(q, k, v, g, av, bv, scale, *schedule,
                                          branch=bwd_branch)
    want_fwd = sa.streaming_attention_fwd_plain(q, k, v, scale, *schedule)
    want = sa.streaming_attention_bwd_plain(q, k, v, g, *want_fwd[1:], scale, *schedule)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,branch", [(torch.bfloat16, 64, "split"),
                                            (torch.float32, 64, "tile"),
                                            (torch.bfloat16, 32, "tile")], ids=str)
def test_autograd_launches_by_branch(cuda, dtype, d, branch):
    """``ops.streaming_attention`` on the card: one forward and one
    backward launch, on the branch the rule picks, none on the other."""
    q, k, v, g = card_inputs(cuda, 16, (2, 2, 300, 90, d), dtype)
    for c in (sa.launches, sa.launches_split, sa.launches_tile):
        c.reset()
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    ops.streaming_attention(*leaves).backward(g)
    torch.cuda.synchronize()
    on, off = ((sa.launches_split, sa.launches_tile) if branch == "split"
               else (sa.launches_tile, sa.launches_split))
    assert (sa.launches.fwd, sa.launches.bwd) == (1, 1)
    assert (on.fwd, on.bwd) == (1, 1) and (off.fwd, off.bwd) == (0, 0)
