"""The port's packed-qkv attention against the JAX package's Pallas kernel.

On the CPU the port runs its plain PyTorch versions (forward and the
hand-derived backward); the JAX side runs ``packed_attention`` in interpret
mode, as ``tests/test_block_attention.py`` does. Both get the same numpy
inputs. Tolerances are the JAX suite's own, in float32: forward atol 2e-6 /
rtol 2e-5, gradients atol 5e-6 / rtol 5e-5.

The branch rule (resident or scratch kernels) is checked here on shapes
alone. The ``gpu`` cases compare the CUDA kernels of both branches with the
plain versions on the card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_packed_attention.py -m gpu
"""

import types

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch.ops import packed_attention
from noise_robust_vit_tpu_torch.ops.attention import packed_dispatch
from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa

torch.set_num_threads(1)

# (robust, sinkhorn_iters, final_row_norm): vanilla plus the three schedules
MODES = [(False, 3, True), (True, 3, True), (True, 4, False), (True, 4, True)]
SHAPES = [(2, 17, 2, 64), (3, 40, 1, 128), (2, 197, 4, 64)]


def _inputs(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    tang = rng.standard_normal((b, n, h * d)).astype(np.float32)
    return qkv, tang


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy and the Pallas packed kernel module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops.pallas import block_attention

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ba=block_attention)


def _jax_fwd_grad(jx, qkv, tang, h, d, robust, iters, final_row):
    def f(x):
        return jx.ba.packed_attention(x, h, d, d**-0.5, robust, iters, final_row, True)

    out, vjp = jx.jax.vjp(f, jx.jnp.asarray(qkv))
    (grad,) = vjp(jx.jnp.asarray(tang))
    return np.asarray(out), np.asarray(grad)


def _torch_fwd_grad(qkv, tang, h, d, robust, iters, final_row):
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = packed_attention(x, h, d, scale=d**-0.5, robust=robust,
                           sinkhorn_iters=iters, final_row_norm=final_row)
    out.backward(torch.from_numpy(tang))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel(jx, mode, shape):
    robust, iters, final_row = mode
    b, n, h, d = shape
    qkv, tang = _inputs(0, b, n, h, d)
    out_j, grad_j = _jax_fwd_grad(jx, qkv, tang, h, d, robust, iters, final_row)
    out_t, grad_t = _torch_fwd_grad(qkv, tang, h, d, robust, iters, final_row)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=2e-5)
    np.testing.assert_allclose(grad_t, grad_j, atol=5e-6, rtol=5e-5)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
def test_residual_rows_match_jax_kernel(jx, mode):
    """The stored scaling vectors and log-normalizer are the JAX kernel's
    residual rows (its buffer pads rows to 8 and columns to 128)."""
    robust, iters, final_row = mode
    b, n, h, d = 2, 17, 2, 64
    qkv, _ = _inputs(1, b, n, h, d)
    _, vecs_j = jx.ba._packed_fwd_impl(jx.jnp.asarray(qkv), h, d, d**-0.5, robust,
                                       iters, final_row, True, want_vecs=True)
    r = jx.ba._num_vecs(iters, final_row, robust)
    _, vecs_t = pa.packed_attention_fwd_plain(torch.from_numpy(qkv), h, d, d**-0.5,
                                              robust, iters, final_row)
    assert vecs_t.shape == (b, h, r, n)
    np.testing.assert_allclose(vecs_t.numpy(), np.asarray(vecs_j)[:, :, :r, :n],
                               atol=2e-6, rtol=2e-5)


def test_uniform_v_rows_sum_to_one():
    """Doubly-stochasticity through the packed path: uniform v ⇒ output rows
    equal v when the rows are normalized last (final row norm)."""
    b, n, h, d = 1, 12, 1, 128
    qkv, _ = _inputs(3, b, n, h, d)
    qkv[..., 2 * h * d:] = 1.0
    out = packed_attention(torch.from_numpy(qkv), h, d, robust=True,
                           sinkhorn_iters=3, final_row_norm=True)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-4)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain version: no kernel is built or launched."""
    pa.launches.reset()
    qkv, tang = _inputs(4, 1, 9, 2, 64)
    _torch_fwd_grad(qkv, tang, 2, 64, True, 3, True)
    assert (pa.launches.fwd, pa.launches.bwd) == (0, 0)


@pytest.mark.parametrize("n,d,ok", [(196, 64, True), (197, 64, True),
                                    (17, 128, True), (17, 48, False),
                                    (pa.MAX_N + 1, 64, False)])
def test_gate(n, d, ok):
    assert packed_dispatch(n, d, 12, 256) is ok


SCHEDULES = [(iters, final) for iters in range(1, pa.MAX_ITERS + 1) for final in (True, False)]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: f"{s[0]}-{int(s[1])}")
@pytest.mark.parametrize("n", [196, 197])
def test_branch_resident_on_main_paths(n, schedule):
    """bf16 at SimpleViT-B/16's and vit_b_16's N with D 64 takes the resident
    kernels, whatever the schedule (their shared memory does not depend on
    it: the backward keeps room for the longest chain's vectors)."""
    iters, final_row = schedule
    assert pa.packed_attention_supported(n, 64, 12, 256, iters)
    assert pa.packed_branch(n, 64, torch.bfloat16) == "resident"


@pytest.mark.parametrize("n,d,dtype", [
    (pa.RESIDENT_MAX_N + 1, 64, torch.bfloat16), (400, 64, torch.bfloat16),
    (pa.MAX_N, 64, torch.bfloat16), (196, 64, torch.float32), (197, 64, torch.float32),
    (196, 32, torch.bfloat16), (196, 128, torch.bfloat16)], ids=str)
def test_branch_scratch_elsewhere(n, d, dtype):
    assert pa.packed_branch(n, d, dtype) == "scratch"


def test_resident_range():
    """The resident range is contiguous from N = 1 and covers the main paths."""
    assert pa.RESIDENT_MAX_N >= 197
    assert all(pa._resident_fits(n, 64) for n in range(1, pa.RESIDENT_MAX_N + 1))
    assert not any(pa._resident_fits(n, 64) for n in range(pa.RESIDENT_MAX_N + 1, 1025))


def test_resident_smem_within_limit():
    """Wherever the rule says resident, both kernels' shared memory (the
    formulas mirrored from csrc, with the static part kept) fits a block on
    sm_90, and the forward matrix's row stride is the conflict-free one.
    The backward holds its matrix in registers: its shared memory is the
    operand ring, the four staging regions, and the vectors, whatever N
    (a tile of the last staging region reads up to 56 rows past it, which
    the vectors after it cover)."""
    bwd = pa._resident_bwd_smem()
    assert bwd + pa._RES_STATIC <= 232448
    assert bwd >= pa._RES_ALIGN + 2 * pa._RES_SLOT_BYTES + 4 * pa._RES_STAGE_BYTES + 56 * 128
    assert pa._RES_SLOT_BYTES % 1024 == 0 and pa._RES_STAGE_BYTES % 1024 == 0
    for n in range(1, pa.RESIDENT_MAX_N + 1):
        assert pa._resident_fwd_smem(n) + pa._RES_STATIC <= 232448
        ld = pa._resident_ld(n)
        assert ld >= n and ld % 8 == 0 and ld % 32 == 8


def test_cuda_wrapper_refuses_cpu_tensor():
    qkv = torch.zeros(1, 4, 3 * 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pa.packed_attention_fwd_cuda(qkv, 1, 64, 0.125)


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(qkv, tang, h, d, robust, iters, final_row):
    scale = d**-0.5
    out_k, vecs_k = pa.packed_attention_fwd_cuda(qkv, h, d, scale, robust, iters, final_row)
    dq_k = pa.packed_attention_bwd_cuda(qkv, tang, vecs_k, h, d, scale, robust,
                                        iters, final_row)
    out_p, vecs_p = pa.packed_attention_fwd_plain(qkv, h, d, scale, robust, iters, final_row)
    dq_p = pa.packed_attention_bwd_plain(qkv, tang, vecs_p, h, d, scale, robust,
                                         iters, final_row)
    torch.cuda.synchronize()
    return (out_k, vecs_k, dq_k), (out_p, vecs_p, dq_p)


def _assert_kernel_matches(got, want):
    """float32: atol 1e-4 / rtol 1e-3 — the sums run in another order than
    the plain version's, and the reverse chain amplifies the difference.
    bfloat16 in and out, float32 inside: outputs agree to a bf16 rounding of
    values of order one (atol 2e-2)."""
    if got[0].dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)
        return
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(got[2].float(), want[2].float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
@pytest.mark.parametrize("shape", [(4, 196, 12, 64), (2, 197, 4, 64),
                                   (2, 40, 2, 128), (2, 65, 3, 32),
                                   (1, 300, 2, 64), (1, pa.MAX_N, 1, 64),
                                   (8, 196, 12, 64), (8, 197, 12, 64), (256, 196, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_f32(cuda, mode, shape):
    robust, iters, final_row = mode
    b, n, h, d = shape
    qkv, tang = (torch.from_numpy(x).to(cuda) for x in _inputs(5, b, n, h, d))
    _assert_kernel_matches(*_kernel_vs_plain(qkv, tang, h, d, robust, iters, final_row))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
@pytest.mark.parametrize("shape", [(4, 196, 12, 64), (2, 197, 4, 64),
                                   (2, 40, 2, 128), (2, 65, 3, 32),
                                   (8, 196, 12, 64), (8, 400, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_bf16(cuda, mode, shape):
    robust, iters, final_row = mode
    b, n, h, d = shape
    qkv, tang = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _inputs(6, b, n, h, d))
    _assert_kernel_matches(*_kernel_vs_plain(qkv, tang, h, d, robust, iters, final_row))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
def test_kernel_walks_several_heads_per_block(cuda, mode, dtype):
    """More heads than the grid has blocks: every block takes at least two
    (image, head) pairs in turn and reuses its scratch slot and its shared
    vectors, which must carry nothing from one head to the next."""
    robust, iters, final_row = mode
    n, h, d = 196, 12, 64
    slots = pa._n_slots(cuda, 1 << 30)
    b = -(-2 * slots // h) + 1
    assert b * h >= 2 * slots and pa._n_slots(cuda, b * h) == slots
    qkv, tang = (torch.from_numpy(x).to(cuda, dtype) for x in _inputs(8, b, n, h, d))
    _assert_kernel_matches(*_kernel_vs_plain(qkv, tang, h, d, robust, iters, final_row))


def _forced_vs_plain(qkv, tang, h, d, robust, iters, final_row, branch):
    scale = d**-0.5
    args = (h, d, scale, robust, iters, final_row)
    out_k, vecs_k = pa.packed_attention_fwd_cuda(qkv, *args, branch=branch)
    dq_k = pa.packed_attention_bwd_cuda(qkv, tang, vecs_k, *args, branch=branch)
    out_p, vecs_p = pa.packed_attention_fwd_plain(qkv, *args)
    dq_p = pa.packed_attention_bwd_plain(qkv, tang, vecs_p, *args)
    torch.cuda.synchronize()
    return (out_k, vecs_k, dq_k), (out_p, vecs_p, dq_p)


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["resident", "scratch"])
@pytest.mark.parametrize("mode", MODES + [(True, 1, False), (True, 8, True)],
                         ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
@pytest.mark.parametrize("shape", [(4, 196, 12, 64), (2, 197, 4, 64), (2, 17, 2, 64),
                                   (3, 130, 2, 64), (1, 198, 2, 64), (8, 196, 12, 64),
                                   (256, 196, 12, 64), (256, 197, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_both_branches_match_plain_bf16(cuda, branch, mode, shape):
    """Each branch on bf16 inside the resident range, against the plain
    version, at SimpleViT-B/16's and vit_b_16's batch of 256 too, where
    every persistent block takes many heads in turn; the resident kernels
    also give the same bits twice."""
    robust, iters, final_row = mode
    b, n, h, d = shape
    qkv, tang = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _inputs(9, b, n, h, d))
    got, want = _forced_vs_plain(qkv, tang, h, d, robust, iters, final_row, branch)
    _assert_kernel_matches(got, want)
    if branch == "resident":
        again, _ = _forced_vs_plain(qkv, tang, h, d, robust, iters, final_row, branch)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_branch_rule_matches_library(cuda):
    """The Python rule and the library's (nrv_packed_resident_fits) agree."""
    from noise_robust_vit_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for n in range(1, 1025):
        for d in (32, 64, 128):
            assert bool(lib.nrv_packed_resident_fits(n, d)) == pa._resident_fits(n, d), (n, d)


@pytest.mark.gpu
def test_resident_branch_refuses_outside_its_range(cuda):
    qkv = torch.zeros(1, pa.RESIDENT_MAX_N + 1, 3 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="resident branch"):
        pa.packed_attention_fwd_cuda(qkv, 1, 64, 0.125, branch="resident")
    with pytest.raises(ValueError, match="resident branch"):
        pa.packed_attention_fwd_cuda(qkv[:, :196].float().contiguous(), 1, 64, 0.125,
                                     branch="resident")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,branch", [(torch.bfloat16, 196, "resident"),
                                            (torch.bfloat16, 300, "scratch"),
                                            (torch.float32, 196, "scratch")], ids=str)
def test_launch_counts_by_branch(cuda, dtype, n, branch):
    qkv, tang = (torch.from_numpy(x).to(cuda, dtype) for x in _inputs(10, 1, n, 2, 64))
    for c in (pa.launches, pa.launches_resident, pa.launches_scratch):
        c.reset()
    _, vecs = pa.packed_attention_fwd_cuda(qkv, 2, 64, 0.125, True)
    pa.packed_attention_bwd_cuda(qkv, tang, vecs, 2, 64, 0.125, True)
    torch.cuda.synchronize()
    on = pa.launches_resident if branch == "resident" else pa.launches_scratch
    off = pa.launches_scratch if branch == "resident" else pa.launches_resident
    assert (pa.launches.fwd, pa.launches.bwd, on.fwd, on.bwd, off.fwd, off.bwd) == (1, 1, 1, 1, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("robust", [False, True])
def test_autograd_on_card_launches_kernels(cuda, robust):
    """``packed_attention`` on a CUDA tensor goes through both kernels, once
    each, and its output and gradient agree with the CPU path."""
    b, n, h, d = 2, 197, 3, 64
    qkv, tang = _inputs(7, b, n, h, d)
    want = _torch_fwd_grad(qkv, tang, h, d, robust, 3, True)
    x = torch.from_numpy(qkv).to(cuda).requires_grad_(True)
    pa.launches.reset()
    out = packed_attention(x, h, d, robust=robust)
    out.backward(torch.from_numpy(tang).to(cuda))
    torch.cuda.synchronize()
    assert (pa.launches.fwd, pa.launches.bwd) == (1, 1)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want[0], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(x.grad.cpu().numpy(), want[1], atol=1e-4, rtol=1e-3)


# The resident backward on its own: the kernel's gradient from the kernel
# forward's residual rows against the plain backward from the same rows.
# N > 128 runs a cluster of two blocks an item, N <= 128 one block.
RESIDENT_BWD_MODES = [(False, 3, True), (True, 3, True), (True, 4, False), (True, 1, True),
                      (True, 1, False), (True, 8, True)]


def _resident_bwd_vs_plain(qkv, tang, h, d, robust, iters, final_row):
    args = (h, d, d**-0.5, robust, iters, final_row)
    _, vecs = pa.packed_attention_fwd_cuda(qkv, *args, branch="resident")
    got = pa.packed_attention_bwd_cuda(qkv, tang, vecs, *args, branch="resident")
    again = pa.packed_attention_bwd_cuda(qkv, tang, vecs, *args, branch="resident")
    want = pa.packed_attention_bwd_plain(qkv, tang, vecs, *args)
    torch.cuda.synchronize()
    return got, again, want


@pytest.mark.gpu
@pytest.mark.parametrize("mode", RESIDENT_BWD_MODES,
                         ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
@pytest.mark.parametrize("shape", [(2, 196, 4, 64), (2, 197, 3, 64), (3, 100, 2, 64),
                                   (2, 128, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_resident_bwd_matches_plain_bf16(cuda, mode, shape):
    """bf16 atol / rtol 2e-2, as every bf16 gradient here; the same bits
    from two runs."""
    b, n, h, d = shape
    qkv, tang = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _inputs(11, b, n, h, d))
    got, again, want = _resident_bwd_vs_plain(qkv, tang, h, d, *mode)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [196, 100])
@pytest.mark.parametrize("mode", [(False, 3, True), (True, 3, True)],
                         ids=lambda m: f"robust{int(m[0])}-{m[1]}-{int(m[2])}")
def test_resident_bwd_walks_several_items(cuda, mode, n):
    """At least three items for every block (N > 128: every cluster) of the
    persistent grid: nothing carries from one item to the next through the
    operand ring, the staging regions or the vectors."""
    h, d = 12, 64
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b = -(-3 * sms // h) + 1
    qkv, tang = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _inputs(12, b, n, h, d))
    got, again, want = _resident_bwd_vs_plain(qkv, tang, h, d, *mode)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)
