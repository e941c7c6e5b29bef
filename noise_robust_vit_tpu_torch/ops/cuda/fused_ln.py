"""Fused LayerNorm over the last axis: ``y = (x − mean)·rstd·scale + bias``
with the moments in float32, differentiable in x, scale and bias.

Counterpart of ``noise_robust_vit_tpu/ops/pallas/fused_ln.py``
(``fused_layer_norm``; its Pallas calls are ``_fwd_impl`` and ``_bwd_impl``).
The math is JAX's ``_fwd_kernel`` and ``_bwd_kernel``: two-pass moments
(the mean, then the mean of (x − mean)²), and a hand-derived backward that
recomputes them,

    dx = rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat)),  dxhat = dy·scale,
    dscale = Σ_rows dy·xhat,  dbias = Σ_rows dy.

x is ``[..., D]`` float32 or bfloat16 and the output and dx have its dtype;
scale and bias are float32 ``[D]`` and so are their gradients. ``eps`` is a
constant, as in JAX's ``custom_vjp`` (``nondiff_argnums``).

Three pieces live here, as in the other kernel modules: the plain PyTorch
versions ``fused_ln_fwd_plain`` / ``fused_ln_bwd_plain``, the ctypes
wrappers of ``csrc/fused_ln_{fwd,bwd}.cu`` with their launch count, and the
autograd function ``FusedLayerNormFn`` behind ``fused_layer_norm``.
"""

from __future__ import annotations

import torch

from .build import LaunchCounts, by_device, check_operand, ptr, raise_on, stream

__all__ = [
    "FusedLayerNormFn",
    "fused_layer_norm",
    "fused_ln_bwd",
    "fused_ln_bwd_cuda",
    "fused_ln_bwd_plain",
    "fused_ln_fwd",
    "fused_ln_fwd_cuda",
    "fused_ln_fwd_plain",
    "fused_ln_supported",
    "launches",
]

# Gate, mirrored in csrc/fused_ln.cuh (``supported``): D a multiple of 32,
# the width of a row split into runs of four over 8 lanes, from 32 to 8192.
# It contains JAX's (``fused_ln.py:38-40``: a multiple of 128, the TPU's lane
# width), which has no reason on this card: the port takes Swin's and CvT's
# widths 64, 96 and 192 as well.
_STEP = 32
MAX_D = 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounts()  # fwd: one a forward call; bwd: one a backward call (two kernels)


def fused_ln_supported(d: int) -> bool:
    """Shape gate of the kernels, decided before any call: D a multiple of
    32, at most 8192."""
    return 0 < d <= MAX_D and d % _STEP == 0


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _moments(x: torch.Tensor, eps: float):
    """``(xc, rstd)`` of float32 rows ``x [R, D]``: two passes, as the
    kernels compute them."""
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    return xc, torch.rsqrt(var + eps)


def fused_ln_fwd_plain(x, scale, bias, eps=1e-5):
    """Forward in eager torch on rows ``x [R, D]``: y in x's dtype."""
    xc, rstd = _moments(x.float(), eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(x.dtype)


def fused_ln_bwd_plain(x, scale, dy, eps=1e-5):
    """Backward in eager torch: ``(dx, dscale, dbias)``, dx in x's dtype,
    the other two float32."""
    xc, rstd = _moments(x.float(), eps)
    xhat = xc * rstd
    dyf = dy.float()
    dxhat = dyf * scale.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/fused_ln_{fwd,bwd}.cu)
# --------------------------------------------------------------------------

def _check(x, scale, others):
    if not x.is_cuda:
        raise ValueError("fused LayerNorm kernel: x must be a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused LayerNorm kernel: dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    if x.ndim != 2 or not fused_ln_supported(x.shape[1]):
        raise ValueError(f"fused LayerNorm kernel: rows {tuple(x.shape)} are outside the gate "
                         f"(D a multiple of {_STEP}, at most {MAX_D})")
    check_operand("fused LayerNorm", "x", x, x)
    d = x.shape[1]
    check_operand("fused LayerNorm", "scale", scale, x, torch.float32, (d,))
    for name, t, dtype, shape in others:
        check_operand("fused LayerNorm", name, t, x, dtype, shape)


def fused_ln_fwd_cuda(x, scale, bias, eps=1e-5):
    """Launch the forward kernel on rows ``x [R, D]``; returns y. Raises on
    anything the kernel does not take."""
    from .build import load_library

    _check(x, scale, [("bias", bias, torch.float32, scale.shape)])
    y = torch.empty_like(x)
    rows, d = x.shape
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        err = load_library().nrv_fused_ln_fwd(
            ptr(x), ptr(scale), ptr(bias), ptr(y), _DTYPE_CODES[x.dtype], rows, d,
            float(eps), stream(x.device))
    raise_on(err, "fused LayerNorm forward kernel")
    launches.fwd += 1
    return y


def fused_ln_bwd_cuda(x, scale, dy, eps=1e-5):
    """Launch the backward kernels (rows, then the sum of the per-block
    dscale/dbias partials); returns ``(dx, dscale, dbias)``."""
    from .build import load_library

    _check(x, scale, [("dy", dy, None, x.shape)])
    rows, d = x.shape
    dx = torch.empty_like(x)
    if rows == 0:
        return (dx, torch.zeros(d, dtype=torch.float32, device=x.device),
                torch.zeros(d, dtype=torch.float32, device=x.device))
    # the sum kernel writes every column of dg and db: no fill
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty(d, dtype=torch.float32, device=x.device)
    lib = load_library()
    # one row of dg/db partials a backward block (csrc bwd_blocks)
    parts = torch.empty(2, lib.nrv_fused_ln_bwd_blocks(rows, d), d, dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nrv_fused_ln_bwd(
            ptr(x), ptr(scale), ptr(dy), ptr(dx), ptr(parts[0]), ptr(parts[1]), ptr(dg),
            ptr(db), _DTYPE_CODES[x.dtype], rows, d, float(eps), stream(x.device))
    raise_on(err, "fused LayerNorm backward kernel")
    launches.bwd += 1
    return dx, dg, db


def fused_ln_fwd(x, scale, bias, eps=1e-5):
    return by_device(fused_ln_fwd_cuda, fused_ln_fwd_plain, x, scale, bias, eps)


def fused_ln_bwd(x, scale, dy, eps=1e-5):
    return by_device(fused_ln_bwd_cuda, fused_ln_bwd_plain, x, scale, dy, eps)


class FusedLayerNormFn(torch.autograd.Function):
    """``x [..., D]`` → LayerNorm over the last axis, with the hand-derived
    backward; ``eps`` is a constant."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = fused_ln_fwd(x2, scale.contiguous(), bias.contiguous(), eps)
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dg, db = fused_ln_bwd(x2, scale.contiguous(), dy.reshape(x2.shape).contiguous(),
                                  ctx.eps)
        return dx.reshape(dy.shape), dg, db, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x [..., D]`` (D inside
    ``fused_ln_supported``): the kernels for a CUDA tensor, the plain
    versions for a CPU tensor."""
    return FusedLayerNormFn.apply(x, scale, bias, float(eps))
