"""The port's biased (windowed) attention against the JAX package's Pallas
kernel.

On the CPU the port runs its plain PyTorch versions (forward and the
hand-derived backward, dbias summed over the images that share a bias
row); the JAX side runs ``biased_attention`` in interpret mode, as
``tests/test_biased_attention.py`` does, at that file's shapes and
tolerances: forward atol 2e-6 / rtol 2e-5, dq, dk, dv and dbias atol 5e-6 /
rtol 5e-5, float32. Both get the same numpy inputs.

The branch rule (``biased_branch``: the resident kernels for bf16 at N ≤
64 and D, DV in 16, 32, 64, the shared-memory kernels for the rest of the
gate) is checked here on the CPU. The ``gpu`` cases compare either
branch's CUDA kernels with the plain versions on the card, and the rule
with the library's, and skip where there is none. JAX is imported only by the tests that
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


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_plain_matches_jax_kernel_at_levit_128s_stage_2(jx, mode):
    """LeViT-128S's stage 2 at batch 2: 8 heads at N = 16, D 16, DV 32, one
    per-head bias (the resident kernels' one-warp items)."""
    robust, iters, final_row = mode
    shape = (2, 8, 16, 16, 32, 1)
    q, k, v, bias, tang = _inputs(10, *shape)
    out_j, grads_j = _jax_fwd_grads(jx, q, k, v, bias, tang, 1, robust, iters, final_row)
    out_t, grads_t = _torch_fwd_grads(q, k, v, bias, tang, 1, robust, iters, final_row)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=2e-5)
    for name, a, b in zip(["dq", "dk", "dv", "dbias"], grads_t, grads_j):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=5e-5, err_msg=name)


BF16, F32 = torch.bfloat16, torch.float32
# (label, N, D, DV): the callers the resident kernels serve
RESIDENT_SITES = [("swin_t", 49, 32, 32), ("swin_v2_t", 64, 32, 32),
                  ("levit_128s stage 1", 49, 16, 32), ("levit_128s stage 2", 16, 16, 32),
                  ("levit_256 stage 1", 49, 32, 64), ("levit_256 stage 2", 16, 32, 64),
                  ("twins local", 49, 64, 64)]
# (label, N, D, DV, dtype): what stays on the shared-memory kernels
SHARED_SITES = [("swin_t float32", 49, 32, 32, F32), ("N 65", 65, 32, 32, BF16),
                ("levit stage 0", 196, 16, 32, BF16), ("levit_256 stage 0", 196, 32, 64, BF16),
                ("D 8", 49, 8, 8, BF16), ("D 128", 49, 128, 128, BF16),
                ("DV 40", 49, 32, 40, BF16)]
SCHEDULES = [(False, 3)] + [(True, i) for i in range(1, 9)]


def _schedule_id(s):
    return f"r{s[1]}" if s[0] else "vanilla"


@pytest.mark.parametrize("schedule", SCHEDULES, ids=_schedule_id)
@pytest.mark.parametrize("site", RESIDENT_SITES, ids=lambda s: s[0])
def test_branch_rule_takes_the_windowed_sites(site, schedule):
    """bf16 Swin-T, swin_v2_t, LeViT's N = 49 and 16 stages and Twins' local
    attention go to the resident kernels, vanilla and robust at 1 to 8
    iterations."""
    _, n, d, dv = site
    assert ba.biased_branch(n, d, dv, BF16, *schedule) == "resident"


@pytest.mark.parametrize("schedule", [(False, 3), (True, 1), (True, 8)], ids=_schedule_id)
@pytest.mark.parametrize("site", SHARED_SITES, ids=lambda s: s[0])
def test_branch_rule_keeps_the_rest_on_shared_memory(site, schedule):
    """float32, N above 64, and widths outside 16, 32, 64 stay on the
    shared-memory kernels."""
    _, n, d, dv, dtype = site
    assert ba.biased_branch(n, d, dv, dtype, *schedule) == "shared"


def test_branch_rule_beyond_eight_iterations():
    assert ba.biased_branch(49, 32, 32, BF16, True, 9) == "shared"
    assert not ba._resident_fits(49, 32, 32, True, 9)


@pytest.mark.parametrize("iters", range(1, 9))
def test_resident_shapes_lie_inside_the_gate(iters):
    """The resident branch takes a subset of the gate's shapes, every N from
    1 to 64 at every width pair: the gate itself is unchanged, and a shape
    the rule calls resident has a kernel in either branch."""
    for n in range(1, 65):
        for d in (16, 32, 64):
            for dv in (16, 32, 64):
                assert ba._resident_fits(n, d, dv, True, iters)
                assert ba._resident_fits(n, d, dv, False, iters)
                assert ba.biased_attention_supported(8, 2, n, d, dv, 2, iters)
    assert not ba._resident_fits(65, 32, 32, True, iters)
    assert [ba._res_items(n) for n in (1, 16, 17, 32, 33, 49, 64)] == [4, 4, 2, 2, 1, 1, 1]


@pytest.mark.parametrize("imgs,pairs,slots", [(128, 192, 396), (32, 96, 528), (128, 24, 396),
                                              (1, 24, 528), (8192, 8, 396), (7, 3, 5)])
def test_resident_walk_covers_every_image_once(imgs, pairs, slots):
    """The resident walk cuts each bias row's images into chunks, none empty,
    that cover every image once; it ends no later than the walk of whole
    rows or of one image a unit (a unit's start counted as half an image)."""
    chunks, per = ba._res_chunks(imgs, pairs, slots)
    assert chunks * per >= imgs and (chunks - 1) * per < imgs
    assert sorted(c * per + i for c in range(chunks) for i in range(per)
                  if c * per + i < imgs) == list(range(imgs))

    def cost(c, p):
        return -(-(c * pairs) // slots) * (p + ba._RES_UNIT_COST)
    assert cost(chunks, per) <= min(cost(1, imgs), cost(imgs, 1))


def test_resident_walk_at_swin_t_stage_0():
    """Swin-T stage 0 at batch 128 (128 images share each of 64 × 3 bias
    rows) on 132 SMs: the backward's three one-item blocks an SM (396
    slots) take 2 chunks of 64 images, 384 units; the forward's four (528
    slots) 8 chunks of 16, 1536 units."""
    assert ba._res_chunks(128, 192, 396) == (2, 64)
    assert ba._res_chunks(128, 192, 528) == (8, 16)


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
    """q, k, v, the bias and the upstream gradient, drawn on the card (the
    main paths' shapes hold hundreds of millions of entries)."""
    bw, h, n, d, dv, nw = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(s, generator=gen, device=device).to(dtype)
                  for s in ((bw, h, n, d), (bw, h, n, d), (bw, h, n, dv), (bw, h, n, dv)))
    return q, k, v, torch.randn((nw, h, n, n), generator=gen, device=device), g


# small shapes, then the main paths': Swin-T's four stages at batch 128 with
# their window counts, swin_v2_t's N = 64 (stages 0 and 3 at batch 32),
# LeViT-128S's three stages at batch 256 (DV 32) and LeViT-256's stages 0
# and 1 at batch 64 (DV 64; at N = 196 the shared-memory backward forms o/a
# and t1 32 columns at a time)
CARD_SHAPES = [(8, 3, 23, 32, 32, 4), (4, 2, 17, 16, 32, 1), (64, 3, 49, 32, 32, 16),
               (16, 3, 64, 32, 32, 4), (4, 4, 196, 16, 32, 1), (32, 8, 49, 64, 64, 1),
               (4, 4, 196, 32, 64, 1), (2, 2, 196, 16, 128, 1),
               (8192, 3, 49, 32, 32, 64), (2048, 6, 49, 32, 32, 16), (512, 12, 49, 32, 32, 4),
               (128, 24, 49, 32, 32, 1), (1568, 3, 64, 32, 32, 49), (32, 24, 64, 32, 32, 1),
               (256, 4, 196, 16, 32, 1), (256, 6, 49, 16, 32, 1), (256, 8, 16, 16, 32, 1),
               (64, 4, 196, 32, 64, 1), (64, 6, 49, 32, 64, 1)]
CARD_MODES = MODES + [(True, 4, True)]
CARD_MODE_IDS = MODE_IDS + ["robust-4-final"]


def _assert_rule_branch_launched(shape, mode, dtype):
    """One launch each way, on the branch the rule picks, none on the other."""
    branch = ba.biased_branch(*shape[2:5], dtype, mode[0], mode[1])
    for name, c in (("resident", ba.launches_resident), ("shared", ba.launches_shared)):
        assert (c.fwd, c.bwd) == ((1, 1) if name == branch else (0, 0)), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", CARD_MODES, ids=CARD_MODE_IDS)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, mode, dtype):
    """Each call on the branch the rule picks; bf16 (either branch) gives the
    same bits twice."""
    robust, iters, final_row = mode
    ts = _card_inputs(6, shape, cuda, dtype)
    for c in (ba.launches_resident, ba.launches_shared):
        c.reset()
    got, want = _kernel_vs_plain(ts, shape[-1], robust, iters, final_row)
    _assert_rule_branch_launched(shape, mode, dtype)
    _assert_kernel_matches(got, want)
    if dtype == torch.bfloat16:
        again, _ = _kernel_vs_plain(ts, shape[-1], robust, iters, final_row)
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", CARD_MODES, ids=CARD_MODE_IDS)
def test_kernel_no_bias_matches_plain(cuda, mode):
    """Twins' local attention with no bias: D = DV = 64, float32 and, at
    its batch of 8192 windows, bf16 too (the resident branch, the same
    bits twice)."""
    robust, iters, final_row = mode
    ts = _card_inputs(7, (32, 8, 49, 64, 64, 1), cuda, torch.float32)
    _assert_kernel_matches(*_kernel_vs_plain(ts, 1, robust, iters, final_row, True))
    for dtype in (torch.float32, torch.bfloat16):
        ts = _card_inputs(7, (8192, 8, 49, 64, 64, 1), cuda, dtype)
        for c in (ba.launches_resident, ba.launches_shared):
            c.reset()
        got, want = _kernel_vs_plain(ts, 1, robust, iters, final_row, True)
        _assert_rule_branch_launched((8192, 8, 49, 64, 64), mode, dtype)
        _assert_kernel_matches(got, want)
        if dtype == torch.bfloat16:
            again, _ = _kernel_vs_plain(ts, 1, robust, iters, final_row, True)
            assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.gpu
def test_dbias_repeats_bit_for_bit(cuda):
    """Many images per bias row, so the shared-memory backward (forced here:
    the rule gives bf16 at N = 49 to the resident kernels, whose repeats
    test_resident_branch_repeats_bit_for_bit checks) sums partials from
    several chunks: two runs give the same bits (no atomics)."""
    ts = _card_inputs(8, (1024, 3, 49, 32, 32, 4), cuda, torch.bfloat16)
    q, k, v, bias, g = ts
    args = (32**-0.5, True, 3, True, 4, False)
    _, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args, branch="shared")
    first = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args, branch="shared")[3]
    again = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args, branch="shared")[3]
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


# --------------------------------------------------------------------------
# on the card: the two branches
# --------------------------------------------------------------------------

# (BW, H, N, D, DV, nW): Swin-T's stage 0 and 3 windows, swin_v2_t's N = 64,
# LeViT-128S's stages 1 and 2, LeViT-256's stage 1, a three-strip item
RESIDENT_SHAPES = [(64, 3, 49, 32, 32, 16), (16, 24, 49, 32, 32, 1), (16, 3, 64, 32, 32, 4),
                   (32, 6, 49, 16, 32, 1), (32, 8, 16, 16, 32, 1), (16, 6, 49, 32, 64, 1),
                   (8, 2, 40, 64, 16, 2)]
ALL_MODES = MODES + [(True, 4, True), (True, 1, True), (True, 1, False), (True, 8, True)]


def _mode_id(m):
    return f"r{m[1]}{'f' if m[2] else ''}" if m[0] else "vanilla"


def _branch_vs_plain(ts, nw, mode, no_bias=False, fwd_branch=None, bwd_branch=None):
    q, k, v, bias, g = ts
    args = (q.shape[-1] ** -0.5, *mode, nw, no_bias)
    out_k, vecs_k = ba.biased_attention_fwd_cuda(q, k, v, bias, *args, branch=fwd_branch)
    grads_k = ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs_k, *args, branch=bwd_branch)
    out_p, vecs_p = ba.biased_attention_fwd_plain(q, k, v, bias, *args)
    grads_p = ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs_p, *args)
    torch.cuda.synchronize()
    return (out_k, vecs_k, *grads_k), (out_p, vecs_p, *grads_p)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ALL_MODES, ids=_mode_id)
@pytest.mark.parametrize("shape", RESIDENT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resident_branch_matches_plain(cuda, shape, mode):
    """bf16 at the windowed models' shapes: the rule picks the resident
    kernels, which launch (and no shared-memory kernel) and agree with the
    plain versions to one bf16 ulp."""
    ts = _card_inputs(20, shape, cuda, torch.bfloat16)
    assert ba.biased_branch(*shape[2:5], torch.bfloat16, mode[0], mode[1]) == "resident"
    for c in (ba.launches_resident, ba.launches_shared):
        c.reset()
    _assert_kernel_matches(*_branch_vs_plain(ts, shape[-1], mode))
    assert (ba.launches_resident.fwd, ba.launches_resident.bwd) == (1, 1)
    assert (ba.launches_shared.fwd, ba.launches_shared.bwd) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_resident_branch_without_bias(cuda, mode):
    """Twins' local attention: D = DV = 64, no bias, no dbias."""
    ts = _card_inputs(21, (32, 8, 49, 64, 64, 1), cuda, torch.bfloat16)
    got, want = _branch_vs_plain(ts, 1, mode, no_bias=True, fwd_branch="resident",
                                 bwd_branch="resident")
    assert got[5] is None
    _assert_kernel_matches(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", range(1, 65))
def test_resident_branch_at_ragged_n(cuda, n):
    """Every N from 1 to 64: padded rows and columns masked, items of one to
    four warps."""
    ts = _card_inputs(22, (6, 2, n, 16, 32, 3), cuda, torch.bfloat16)
    _assert_kernel_matches(*_branch_vs_plain(ts, 3, (True, 3, True), fwd_branch="resident",
                                             bwd_branch="resident"))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES[:2], ids=_mode_id)
@pytest.mark.parametrize("shape", [(64, 3, 49, 32, 32, 16), (1024, 3, 49, 32, 32, 4),
                                   (64, 8, 16, 16, 32, 1)], ids=lambda s: "x".join(map(str, s)))
def test_resident_branch_repeats_bit_for_bit(cuda, shape, mode):
    """Column sums over an item's warps run in strip order and dbias adds
    each unit's images in image order, its chunks in chunk order (several
    chunks at 256 images a bias row): two runs give the same bits."""
    ts = _card_inputs(23, shape, cuda, torch.bfloat16)
    first = _branch_vs_plain(ts, shape[-1], mode)[0]
    again = _branch_vs_plain(ts, shape[-1], mode)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    if shape[0] == 1024:
        assert ba._res_walk(ts[0], ts[2], shape[-1], mode[0], mode[1], True)[0] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_branch,bwd_branch", [("resident", "shared"), ("shared", "resident")])
def test_branches_share_the_residual_rows(cuda, fwd_branch, bwd_branch):
    """Either branch's forward feeds either branch's backward: the residual
    rows are the same."""
    ts = _card_inputs(24, (64, 3, 49, 32, 32, 16), cuda, torch.bfloat16)
    _assert_kernel_matches(*_branch_vs_plain(ts, 16, (True, 3, True), False, fwd_branch,
                                             bwd_branch))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", CARD_MODES, ids=_mode_id)
def test_shared_branch_forced_in_bf16(cuda, mode):
    """The shared-memory kernels still take bf16 at Swin-T's stage-0 shape
    when asked, at a small batch and at its batch of 128 (8192 windows),
    and give the same bits twice."""
    for shape in ((64, 3, 49, 32, 32, 16), (8192, 3, 49, 32, 32, 64)):
        ts = _card_inputs(25, shape, cuda, torch.bfloat16)
        for c in (ba.launches_resident, ba.launches_shared):
            c.reset()
        got, want = _branch_vs_plain(ts, shape[-1], mode, fwd_branch="shared",
                                     bwd_branch="shared")
        _assert_kernel_matches(got, want)
        assert (ba.launches_shared.fwd, ba.launches_shared.bwd) == (1, 1)
        assert (ba.launches_resident.fwd, ba.launches_resident.bwd) == (0, 0)
        again, _ = _branch_vs_plain(ts, shape[-1], mode, fwd_branch="shared",
                                    bwd_branch="shared")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), shape


@pytest.mark.gpu
def test_branch_rule_matches_library(cuda):
    """The Python rule and the library's (nrv_biased_resident_fits) agree."""
    from noise_robust_vit_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for n in range(1, 81):
        for d in (8, 16, 32, 40, 64, 128):
            for dv in (8, 16, 32, 40, 64, 128):
                for robust, iters in ((False, 3), (True, 1), (True, 3), (True, 8), (True, 9)):
                    assert bool(lib.nrv_biased_resident_fits(n, d, dv, int(robust), iters)) == \
                        ba._resident_fits(n, d, dv, robust, iters), (n, d, dv, robust, iters)


@pytest.mark.gpu
def test_resident_branch_refuses_what_it_does_not_take(cuda):
    for shape, dtype in (((4, 2, 49, 32, 32, 1), torch.float32),
                         ((4, 2, 49, 8, 8, 1), torch.bfloat16),
                         ((4, 2, 196, 16, 32, 1), torch.bfloat16)):
        q, k, v, bias, _ = _card_inputs(26, shape, cuda, dtype)
        with pytest.raises(ValueError, match="resident branch"):
            ba.biased_attention_fwd_cuda(q, k, v, bias, 0.25, True, branch="resident")


@pytest.mark.gpu
@pytest.mark.parametrize("name,want", [("swin_t", ((12, 12), (0, 0))),
                                       ("levit", ((7, 7), (2, 2))),
                                       ("LeViT_256", ((8, 8), (4, 4)))])
def test_robust_step_launch_split(cuda, name, want):
    """A robust bf16 forward and backward launches the resident kernels at
    every N ≤ 64 site and the shared-memory ones at N = 196: Swin-T 12 and 0
    each way, LeViT-128S 7 and 2, LeViT-256 8 and 4; a vanilla one neither."""
    from noise_robust_vit_tpu_torch import create_model

    x = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (2, 224, 224, 3), dtype=np.float32)).to(cuda, torch.bfloat16)
    for robust in (True, False):
        model = create_model(name, num_classes=10, robust=robust, dtype=torch.bfloat16,
                             device=cuda, seed=0)
        for c in (ba.launches_resident, ba.launches_shared):
            c.reset()
        model(x).float().square().sum().backward()
        torch.cuda.synchronize()
        got = ((ba.launches_resident.fwd, ba.launches_resident.bwd),
               (ba.launches_shared.fwd, ba.launches_shared.bwd))
        assert got == (want if robust else ((0, 0), (0, 0)))
