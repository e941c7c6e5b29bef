"""The port's talking-heads Sinkhorn (pre-mix → softmax + Sinkhorn →
post-mix) against the JAX package's Pallas kernel.

On the CPU the port runs its plain PyTorch versions (the forward and the
hand-derived backward from the stored residual rows); the JAX side runs
``talking_heads_sinkhorn`` in interpret mode, as
``tests/test_talking_heads.py`` does. Both get the same numpy dots, mixes
and upstream gradient. Tolerances, float32, the JAX suite's own
(``tests/test_talking_heads.py``): values atol 2e-6 / rtol 2e-5, gradients
atol and rtol 5e-5.

The ``gpu`` cases compare the CUDA kernels of both branches (cluster and
plane) with the plain versions on the card and skip where there is none. JAX is imported only by the tests that
compare with it, so the file also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_talking_heads.py -m gpu
"""

import types

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch import ops
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss
from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th

torch.set_num_threads(1)

# (sinkhorn_iters, final_row_norm)
SCHEDULES = [(3, True), (4, False)]
SCHEDULE_IDS = ["3-final", "4"]
VALUES = dict(atol=2e-6, rtol=2e-5)
GRADS = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, b=2, h=4, n=21, scale=2.0):
    """dots, pre, post and the upstream gradient, float32, from a seed."""
    rng = np.random.default_rng(seed)
    dots = (scale * rng.standard_normal((b, h, n, n))).astype(np.float32)
    pre, post = (rng.standard_normal((h, h)).astype(np.float32) for _ in range(2))
    return dots, pre, post, rng.standard_normal((b, h, n, n)).astype(np.float32)


def _unfused(dots, pre, post, iters, final_row):
    """einsum → softmax + the vector-form Sinkhorn → einsum, in torch."""
    mixed = torch.einsum("bhij,hg->bgij", dots, pre)
    attn = ops.sinkhorn_normalize(torch.softmax(mixed, -1), iters, final_row)
    return torch.einsum("bhij,hg->bgij", attn, post)


@pytest.fixture
def jx():
    """The JAX reference: jax, jax.numpy and the Pallas kernel module."""
    jax = pytest.importorskip("jax")
    from noise_robust_vit_tpu.ops.pallas import talking_heads as jth

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, th=jth)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("n", [21, 24])  # ragged rows, and runs of four
def test_plain_forward_matches_jax_kernel(jx, n, schedule):
    iters, final_row = schedule
    dots, pre, post, _ = _inputs(0, n=n)
    want = jx.th.talking_heads_sinkhorn(jx.jnp.asarray(dots), jx.jnp.asarray(pre),
                                        jx.jnp.asarray(post), iters, final_row, True)
    out, _ = th.talking_heads_fwd_plain(*map(torch.from_numpy, (dots, pre, post)), iters,
                                        final_row)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **VALUES)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("n", [21, 24])
def test_plain_residual_rows_match_jax_kernel(jx, n, schedule):
    """The stored stack is the JAX kernel's, without its padding to the
    8-row tile."""
    iters, final_row = schedule
    dots, pre, post, _ = _inputs(1, n=n)
    _, vecs_j = jx.th._th_fwd_impl(jx.jnp.asarray(dots), jx.jnp.asarray(pre),
                                   jx.jnp.asarray(post), iters, final_row, True, want_vecs=True)
    _, vecs_t = th.talking_heads_fwd_plain(*map(torch.from_numpy, (dots, pre, post)), iters,
                                           final_row)
    b, h = dots.shape[:2]
    r = ss.num_vecs(iters, final_row, True)
    assert vecs_t.shape == (b * h, r, n)
    want = np.asarray(vecs_j)[:, :, :r, :n].reshape(b * h, r, n)
    np.testing.assert_allclose(vecs_t.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("n", [21, 24])
def test_plain_gradients_match_jax_grad(jx, n, schedule):
    """d dots, d pre and d post of the plain backward (through
    ``TalkingHeadsSinkhorn`` on CPU tensors) against ``jax.grad`` of the
    interpret-mode kernel."""
    iters, final_row = schedule
    dots, pre, post, tang = _inputs(2, n=n)

    def loss(d, p, q):
        return jx.jnp.sum(jx.th.talking_heads_sinkhorn(d, p, q, iters, final_row, True)
                          * jx.jnp.asarray(tang))

    want = jx.jax.grad(loss, argnums=(0, 1, 2))(*map(jx.jnp.asarray, (dots, pre, post)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (dots, pre, post)]
    th.TalkingHeadsSinkhorn.apply(*args, iters, final_row).backward(torch.from_numpy(tang))
    for name, a, w in zip(("ddots", "dpre", "dpost"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), err_msg=name, **GRADS)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
def test_autograd_function_equals_unfused_torch(schedule):
    """``TalkingHeadsSinkhorn`` (plain versions) against autograd through
    the unfused torch sandwich: values and all three gradients."""
    iters, final_row = schedule
    dots, pre, post, tang = _inputs(3, h=3, n=13)
    fused = [torch.from_numpy(a).requires_grad_(True) for a in (dots, pre, post)]
    unfused = [torch.from_numpy(a).requires_grad_(True) for a in (dots, pre, post)]
    out_f = th.TalkingHeadsSinkhorn.apply(*fused, iters, final_row)
    out_u = _unfused(*unfused, iters, final_row)
    torch.testing.assert_close(out_f, out_u, **VALUES)
    out_f.backward(torch.from_numpy(tang))
    out_u.backward(torch.from_numpy(tang))
    for name, a, b in zip(("ddots", "dpre", "dpost"), fused, unfused):
        torch.testing.assert_close(a.grad, b.grad, msg=name, **GRADS)


def test_robust_softmax_dispatch(monkeypatch):
    """``ops.talking_heads_robust_softmax``: robust square shapes inside the
    gate go through ``TalkingHeadsSinkhorn`` and equal the unfused sandwich;
    the CLS stage's one query row and a float16 input take the unfused one;
    vanilla is einsum → softmax → einsum."""
    calls = []
    real = th.TalkingHeadsSinkhorn.apply
    monkeypatch.setattr(th.TalkingHeadsSinkhorn, "apply", lambda x, *a: (
        calls.append(tuple(x.shape)) or real(x, *a)))
    dots, pre, post, _ = (torch.from_numpy(a) for a in _inputs(4, h=2, n=16))
    fused = ops.talking_heads_robust_softmax(dots, pre, post, robust=True)
    assert calls == [(2, 2, 16, 16)]
    torch.testing.assert_close(fused, _unfused(dots, pre, post, 3, True), atol=5e-6, rtol=2e-5)
    calls.clear()
    vanilla = ops.talking_heads_robust_softmax(dots, pre, post, robust=False)
    want = torch.einsum("bhij,hg->bgij",
                        torch.softmax(torch.einsum("bhij,hg->bgij", dots, pre), -1), post)
    torch.testing.assert_close(vanilla, want, atol=1e-6, rtol=1e-6)
    row = dots[:, :, :1]  # [B, H, 1, N]: the CLS stage's logits
    got = ops.talking_heads_robust_softmax(row, pre, post, robust=True)
    torch.testing.assert_close(got, _unfused(row, pre, post, 3, True), atol=1e-6, rtol=1e-5)
    ops.talking_heads_robust_softmax(dots.half(), pre, post, robust=True)
    assert calls == []


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain versions: no kernel is built or
    launched, none of the logits-interface kernels either."""
    for counts in (th.launches, ss.launches, ss.launches_rect):
        counts.reset()
    dots, pre, post, _ = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(5, n=9))
    ops.talking_heads_robust_softmax(dots, pre, post, robust=True).sum().backward()
    assert all((c.fwd, c.bwd) == (0, 0) for c in (th.launches, ss.launches, ss.launches_rect))
    assert pre.grad is not None and post.grad is not None


@pytest.mark.parametrize("shape,iters,ok", [
    ((2, 4, 21, 21), 3, True),
    ((128, 8, 196, 196), 3, True),      # CaiT @224
    ((8, 16, 196, 196), 3, True),       # 16 heads (JAX's VMEM budget refuses it)
    ((2, 8, 228, 228), 3, True),        # the largest matrix at 3 iterations
    ((2, 8, 229, 229), 3, False),
    ((2, 8, 197, 197), 8, True),
    ((2, 4, 21, 20), 3, False),         # rectangular
    ((4, 21, 21), 3, False),            # 3-D
    ((2, 4, 1000, 1000), 3, False),     # beyond shared memory
    ((2, 32, 196, 196), 3, False),      # too many heads
    ((2, 8, 1, 197), 3, False),         # the CLS stage's one query row
    ((2, 4, 21, 21), 9, False),         # more than 8 iterations
    ((2, 4, 21, 21), 0, False),
])
def test_gate(shape, iters, ok):
    """The port's gate is a shared-memory budget for one (image, mixed
    head) matrix per block; it does not depend on H up to the kernels' 16.
    JAX's budget holds all H planes of an image in VMEM at once, so it
    refuses [·, 16, 196, 196] where the port takes it."""
    assert th.talking_heads_supported(shape, iters) is ok
    assert th.talking_heads_supported(shape, iters, torch.float16) is False


def test_gate_agrees_with_jax_where_both_budgets_allow(jx):
    for shape in [(2, 4, 21, 21), (2, 4, 21, 20), (4, 21, 21), (2, 4, 1000, 1000),
                  (2, 32, 196, 196), (128, 8, 196, 196)]:
        assert th.talking_heads_supported(shape, 3) is jx.th.talking_heads_supported(shape, 3)
    assert not jx.th.talking_heads_supported((8, 16, 196, 196), 3)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("n", [21, 24])
def test_plain_strips_match_jax_grad(jx, n, schedule):
    """The plain backward with ``strips=H``, d pre and d post summed as the
    cluster kernels sum them (per-(image, strip) partials, then the images,
    then the strips), against ``jax.grad`` of the interpret-mode kernel."""
    iters, final_row = schedule
    dots, pre, post, tang = _inputs(11, n=n)

    def loss(d, p, q):
        return jx.jnp.sum(jx.th.talking_heads_sinkhorn(d, p, q, iters, final_row, True)
                          * jx.jnp.asarray(tang))

    want = jx.jax.grad(loss, argnums=(0, 1, 2))(*map(jx.jnp.asarray, (dots, pre, post)))
    d, p, q = map(torch.from_numpy, (dots, pre, post))
    _, vecs = th.talking_heads_fwd_plain(d, p, q, iters, final_row)
    got = th.talking_heads_bwd_plain(d, torch.from_numpy(tang), vecs, p, q, iters, final_row,
                                     strips=dots.shape[1])
    for name, g, w in zip(("ddots", "dpre", "dpost"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRADS)


@pytest.mark.parametrize("strips", [1, 4, 5], ids=["one", "H", "ragged"])
def test_plain_strips_sum_like_unsplit(strips):
    """Strips change only the order of d pre's and d post's sums: d dots is
    the same tensor, and the parameter gradients agree within rounding (5
    strips of 21 rows are 4, 4, 4, 4 and 5 rows)."""
    dots, pre, post, tang = (torch.from_numpy(a) for a in _inputs(12, h=4, n=21))
    _, vecs = th.talking_heads_fwd_plain(dots, pre, post)
    want = th.talking_heads_bwd_plain(dots, tang, vecs, pre, post)
    got = th.talking_heads_bwd_plain(dots, tang, vecs, pre, post, strips=strips)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("dpre", "dpost"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("shape,iters,dtype,want", [
    ((128, 8, 196, 196), 3, torch.float32, "cluster"),   # CaiT @224
    ((128, 8, 196, 196), 3, torch.bfloat16, "cluster"),
    ((16, 8, 197, 197), 8, torch.float32, "cluster"),    # ragged N at 8 iterations
    ((8, 16, 196, 196), 3, torch.float32, "plane"),      # 16 heads
    ((2, 8, 201, 201), 3, torch.float32, "plane"),       # N above the cluster limit
    ((2, 2, 224, 224), 4, torch.bfloat16, "plane"),
    ((5, 1, 7, 7), 3, torch.float32, "cluster"),         # one head
    ((4, 4, 2, 2), 1, torch.float32, "cluster"),         # the smallest N
    ((2, 4, 21, 21), 3, torch.float16, "plane"),         # outside the gate
], ids=["cait-f32", "cait-bf16", "197", "16-heads", "201", "224", "one-head", "n2", "f16"])
def test_branch_rule(shape, iters, dtype, want):
    """The cluster branch takes float32 and bf16 at 1-8 heads and N up to
    200 (one plane a block at 8 iterations); the plane branch the rest of
    the gate."""
    assert th.talking_heads_branch(shape, iters, dtype) == want


def test_cuda_wrapper_refuses_forced_branch_outside_its_rule():
    """A forced ``branch="cluster"`` outside the rule raises in both
    directions before anything is launched; so does a branch that does not
    exist. Inside the rule, either branch gets as far as the device check."""
    dots, pre, post, g = (torch.from_numpy(a) for a in _inputs(13, b=1, h=16, n=8))
    _, vecs = th.talking_heads_fwd_plain(dots, pre, post)
    with pytest.raises(ValueError, match="cluster branch does not take"):
        th.talking_heads_fwd_cuda(dots, pre, post, branch="cluster")
    with pytest.raises(ValueError, match="cluster branch does not take"):
        th.talking_heads_bwd_cuda(dots, g, vecs, pre, post, branch="cluster")
    dots, pre, post, _ = (torch.from_numpy(a) for a in _inputs(13, b=1, h=4, n=8))
    with pytest.raises(ValueError, match="no branch"):
        th.talking_heads_fwd_cuda(dots, pre, post, branch="resident")
    for branch in th.BRANCHES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            th.talking_heads_fwd_cuda(dots, pre, post, branch=branch)


def test_cuda_wrapper_refuses_cpu_tensor():
    dots, pre, post, _ = (torch.from_numpy(a) for a in _inputs(6, n=8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        th.talking_heads_fwd_cuda(dots, pre, post)


# --------------------------------------------------------------------------
# on the card: kernel against plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(dots, g, pre, post, iters, final_row, branch=None):
    """(kernel, plain) results: (out, vecs, ds, dpre, dpost). The plain
    backward sums d pre and d post as the branch's kernels do."""
    out_k, vecs_k = th.talking_heads_fwd_cuda(dots, pre, post, iters, final_row, branch=branch)
    grads_k = th.talking_heads_bwd_cuda(dots, g, vecs_k, pre, post, iters, final_row,
                                        branch=branch)
    chosen = branch or th.talking_heads_branch(dots.shape, iters, dots.dtype)
    strips = dots.shape[1] if chosen == "cluster" else None
    out_p, vecs_p = th.talking_heads_fwd_plain(dots, pre, post, iters, final_row)
    grads_p = th.talking_heads_bwd_plain(dots, g, vecs_p, pre, post, iters, final_row,
                                         strips=strips)
    torch.cuda.synchronize()
    return (out_k, vecs_k, *grads_k), (out_p, vecs_p, *grads_p)


def _assert_kernel_matches(got, want):
    """float32: out, vecs and d dots atol 1e-4 / rtol 1e-3, the sums run
    in another order than the plain version's and the reverse chain
    amplifies it; d pre and d post, sums over every image and entry, to
    1e-4 of the tensor's largest magnitude. bfloat16 dots (math in float32):
    out and d dots atol 2e-2 (one bf16 rounding of values of order one),
    vecs 1e-3, d pre and d post 1e-3 of the largest magnitude."""
    bf16 = got[0].dtype == torch.bfloat16
    for i, (g, w) in enumerate(zip(got, want)):
        if i >= 3:
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            assert err <= (1e-3 if bf16 else 1e-4) * scale, (i, err, scale)
        elif i == 1:
            torch.testing.assert_close(g, w, atol=1e-3 if bf16 else 1e-4, rtol=1e-3)
        elif bf16:
            torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=0, msg=f"output {i}")
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3, msg=f"output {i}")


def _card_inputs(cuda, seed, shape, dtype=torch.float32):
    b, h, n, _ = shape
    dots, pre, post, g = _inputs(seed, b, h, n)
    return (torch.from_numpy(dots).to(cuda, dtype), torch.from_numpy(g).to(cuda, dtype),
            torch.from_numpy(pre).to(cuda), torch.from_numpy(post).to(cuda))


# CaiT's N, ragged N, 16 heads, the largest matrix at 4 iterations (224),
# one head; then CaiT @224 at its batch of 128 and at 16, ragged N at a
# larger batch, 16 heads at batch 8
CARD_SHAPES = [(4, 8, 196, 196), (4, 8, 197, 197), (3, 4, 21, 21), (2, 16, 196, 196),
               (2, 2, 224, 224), (5, 1, 7, 7), (128, 8, 196, 196), (16, 8, 196, 196),
               (4, 4, 21, 21), (8, 16, 196, 196)]
# every card shape on the plane branch (forced), and on the cluster branch
# where the rule sends it there (the rule does not depend on the dtype)
CARD_CASES = [(shape, branch) for shape in CARD_SHAPES for branch in th.BRANCHES
              if branch == "plane" or th.talking_heads_branch(shape, 4, torch.float32) == branch]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("shape,branch", CARD_CASES,
                         ids=["x".join(map(str, s)) + "-" + b for s, b in CARD_CASES])
def test_kernel_matches_plain(cuda, shape, branch, schedule, dtype):
    """One launch each way, on the branch asked for and on no other."""
    dots, g, pre, post = _card_inputs(cuda, 7, shape, dtype)
    for counts in (th.launches_cluster, th.launches_plane):
        counts.reset()
    _assert_kernel_matches(*_kernel_vs_plain(dots, g, pre, post, *schedule, branch=branch))
    for name, counts in (("cluster", th.launches_cluster), ("plane", th.launches_plane)):
        assert (counts.fwd, counts.bwd) == ((1, 1) if name == branch else (0, 0)), name


@pytest.mark.gpu
@pytest.mark.parametrize("branch", th.BRANCHES)
@pytest.mark.parametrize("final_row", [False, True])
@pytest.mark.parametrize("iters", [1, 2, 8])
def test_kernel_matches_plain_at_every_iteration_count(cuda, iters, final_row, branch):
    dots, g, pre, post = _card_inputs(cuda, 8, (2, 8, 196, 196))
    _assert_kernel_matches(*_kernel_vs_plain(dots, g, pre, post, iters, final_row,
                                             branch=branch))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,branch", [((16, 8, 196, 196), "plane"),
                                          ((4, 16, 197, 197), "plane"),
                                          ((16, 8, 196, 196), "cluster"),
                                          ((4, 8, 197, 197), "cluster"),
                                          ((128, 8, 196, 196), "plane"),
                                          ((128, 8, 196, 196), "cluster")])
def test_kernel_repeats_bit_for_bit(cuda, shape, branch):
    """No atomics: d pre and d post are summed through partials in a fixed
    order (per item on the plane branch, per (image, strip) on the cluster
    branch), so two runs give the same bits."""
    inputs = _card_inputs(cuda, 9, shape)
    first = _kernel_vs_plain(*inputs, 3, True, branch=branch)[0]
    again = _kernel_vs_plain(*inputs, 3, True, branch=branch)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("fwd_branch,bwd_branch", [("plane", "cluster"), ("cluster", "plane")])
def test_residuals_cross_branches(cuda, fwd_branch, bwd_branch, schedule):
    """Both branches store the same residual rows: either backward takes
    the other forward's, and both forwards agree."""
    dots, g, pre, post = _card_inputs(cuda, 14, (4, 8, 196, 196))
    out_k, vecs_k = th.talking_heads_fwd_cuda(dots, pre, post, *schedule, branch=fwd_branch)
    grads_k = th.talking_heads_bwd_cuda(dots, g, vecs_k, pre, post, *schedule, branch=bwd_branch)
    out_p, vecs_p = th.talking_heads_fwd_plain(dots, pre, post, *schedule)
    strips = 8 if bwd_branch == "cluster" else None
    grads_p = th.talking_heads_bwd_plain(dots, g, vecs_p, pre, post, *schedule, strips=strips)
    torch.cuda.synchronize()
    _assert_kernel_matches((out_k, vecs_k, *grads_k), (out_p, vecs_p, *grads_p))


@pytest.mark.gpu
def test_cluster_library_refuses_outside_its_rule(cuda):
    """The C entry points refuse what ``talking_heads_branch`` keeps off
    the cluster branch (16 and 9 heads, N = 201, 9 iterations), so the two
    rules agree at their edges."""
    from noise_robust_vit_tpu_torch.ops.cuda import build

    lib = build.load_library()
    assert lib.nrv_talking_heads_cluster_fwd_clusters(0, 8, 196) >= 1
    assert lib.nrv_talking_heads_cluster_bwd_clusters(0, 8, 200, 8, 1) >= 1
    for h, n, iters in ((16, 196, 3), (8, 201, 3), (8, 196, 9), (9, 196, 3)):
        assert lib.nrv_talking_heads_cluster_bwd_clusters(0, h, n, iters, 1) == -1
    for h, n in ((1, 2), (8, 200)):
        assert th.talking_heads_branch((1, h, n, n), 8, torch.float32) == "cluster"
        assert lib.nrv_talking_heads_cluster_fwd_clusters(1, h, n) >= 1


@pytest.mark.gpu
def test_autograd_on_card_launches_kernels(cuda):
    """``talking_heads_robust_softmax`` on CUDA dots goes through one
    forward and one backward launch, on the cluster branch at 4 heads, and
    agrees with the CPU path."""
    dots, pre, post, g = _inputs(10, 2, 4, 49)
    cpu = [torch.from_numpy(a).requires_grad_(True) for a in (dots, pre, post)]
    want = ops.talking_heads_robust_softmax(*cpu, robust=True)
    want.backward(torch.from_numpy(g))
    for counts in (th.launches, th.launches_cluster, th.launches_plane):
        counts.reset()
    card = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (dots, pre, post)]
    out = ops.talking_heads_robust_softmax(*card, robust=True)
    out.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert (th.launches.fwd, th.launches.bwd) == (1, 1)
    assert (th.launches_cluster.fwd, th.launches_cluster.bwd) == (1, 1)
    assert (th.launches_plane.fwd, th.launches_plane.bwd) == (0, 0)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.detach().numpy(),
                               atol=1e-4, rtol=1e-3)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("h,n,branch", [(8, 196, "cluster"), (1, 7, "cluster"),
                                        (16, 20, "plane"), (2, 210, "plane")])
def test_autograd_launch_counts_by_branch(cuda, h, n, branch):
    """Each robust call launches one forward and one backward, on the branch
    the rule picks and on no other."""
    dots, pre, post, g = _inputs(15, 2, h, n)
    for counts in (th.launches, th.launches_cluster, th.launches_plane):
        counts.reset()
    card = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (dots, pre, post)]
    ops.talking_heads_robust_softmax(*card, robust=True).backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    mine = th.launches_cluster if branch == "cluster" else th.launches_plane
    other = th.launches_plane if branch == "cluster" else th.launches_cluster
    assert (th.launches.fwd, th.launches.bwd) == (1, 1)
    assert (mine.fwd, mine.bwd) == (1, 1)
    assert (other.fwd, other.bwd) == (0, 0)
