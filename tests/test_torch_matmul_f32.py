"""``ops.matmul_f32``: the port's float32 logits and attention products, as
the JAX package's ``preferred_element_type=jnp.float32``.

On the CPU (and for float32 operands anywhere) it is the upcast
``torch.matmul``, to the bit, gradients included. The ``gpu`` cases hold the
bf16 route (``aten::bmm.dtype`` on the tensor cores; its backward the upcast
product's float32 GEMMs) against the upcast float32 product on the card: the
products of bf16 values are exact in float32, so the forward differs only
in the order of the sum (atol and rtol 1e-4 at D = 64), and the gradients,
rounded to bf16, by at most about one bf16 ulp where the GEMMs sum in
another order (atol and rtol 1e-2).

    python -m pytest --noconftest tests/test_torch_matmul_f32.py -m gpu
"""

import numpy as np
import pytest
import torch

from noise_robust_vit_tpu_torch import ops

torch.set_num_threads(1)

# (a, b) shapes: CvT stage-2 logits, LeViT's subsample (broadcast batch),
# Swin-T windows, attn · v
SHAPES = [((2, 3, 49, 64), (2, 3, 64, 196)), ((2, 4, 16, 16), (1, 4, 16, 49)),
          ((8, 3, 49, 32), (8, 3, 32, 49)), ((2, 6, 49, 49), (2, 6, 49, 64))]


def _operands(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                 for s in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s[0])))
def test_cpu_is_the_upcast_matmul(shapes, dtype):
    """On the CPU: float32 out, the upcast product's bits, and the same
    gradients in the operands' dtype."""
    a, b = (t.requires_grad_(True) for t in _operands(0, shapes, dtype))
    got = ops.matmul_f32(a, b)
    assert got.dtype == torch.float32
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(got.shape).astype(np.float32))
    grads = torch.autograd.grad(got, (a, b), g)
    a2, b2 = (t.detach().clone().requires_grad_(True) for t in (a, b))
    want = torch.matmul(a2.float(), b2.float())
    want_grads = torch.autograd.grad(want, (a2, b2), g)
    assert torch.equal(got, want)
    for x, y in zip(grads, want_grads):
        assert x.dtype == dtype and torch.equal(x, y)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s[0])))
def test_bf16_route_matches_float32_product(cuda, shapes):
    """bf16 on the card: the tensor-core product against the upcast float32
    one, forward and both gradients."""
    a, b = (t.to(cuda).requires_grad_(True) for t in _operands(2, shapes, torch.bfloat16))
    got = ops.matmul_f32(a, b)
    assert got.dtype == torch.float32
    g = torch.randn(got.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    grads = torch.autograd.grad(got, (a, b), g)
    a2, b2 = (t.detach().clone().requires_grad_(True) for t in (a, b))
    want = torch.matmul(a2.float(), b2.float())
    want_grads = torch.autograd.grad(want, (a2, b2), g)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for name, x, y in zip("ab", grads, want_grads):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float(), y.float(), atol=1e-2, rtol=1e-2, msg=name)
