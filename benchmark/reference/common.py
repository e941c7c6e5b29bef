"""Plain float32 pieces shared by the reference models, and the reference's
train step: micro-batched forward and backward, mean cross-entropy and a
plain AdamW update. Plain ``torch`` only; nothing of the program is
imported. Parameters come in as a dict of named float32 tensors.

``rnd`` is applied to both operands of every product that the configuration
computes in bf16 (the linear layers, q·kᵀ and attention·v). The reference
passes ``exact`` (float32, TF32 off); the control passes ``fp8``, the next
precision below bf16.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8(torch.autograd.Function):
    """e4m3 with a per-tensor scale (the tensor's largest magnitude onto
    448), straight through in the backward."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-12)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def float32_exact() -> None:
    """Products in true float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x, w, b=None, rnd: Rounding = exact):
    return F.linear(rnd(x), rnd(w), b)


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x, cfg: dict):
    """The configuration's GELU: the tanh form where the model computes in
    bf16 or float16, erf in float32 (the port's and the JAX package's
    dtype-aware GELU); computed here in float32 either way."""
    return F.gelu(x, approximate="none" if cfg["dtype"] == "float32" else "tanh")


def attention_weights(logits: torch.Tensor, robust: bool, iters: int = 3,
                      final_row: bool = True) -> torch.Tensor:
    """Row softmax, then with ``robust`` the reference's Sinkhorn rewrites:
    ``iters`` times a row then a column normalization, then a last row
    normalization (ref utils.py:1025-1037), literally."""
    attn = torch.softmax(logits, dim=-1)
    if robust:
        for _ in range(iters):
            attn = attn / attn.sum(-1, keepdim=True)
            attn = attn / attn.sum(-2, keepdim=True)
        if final_row:
            attn = attn / attn.sum(-1, keepdim=True)
    return attn


def attend(q, k, v, scale: float, robust: bool, bias=None, rnd: Rounding = exact,
           iters: int = 3, final_row: bool = True):
    """``weights(scale·q·kᵀ [+ bias]) · v`` over ``[..., N, D]``."""
    logits = torch.matmul(rnd(q), rnd(k).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    attn = attention_weights(logits, robust, iters, final_row)
    return torch.matmul(rnd(attn), rnd(v))


# AdamW's moment decays and eps, which the configuration does not set: the
# reference's, and those the harness requires of the program's optimizer
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8


def adamw_(params: dict, grads: dict, state: dict, t: int, opt: dict) -> None:
    """One AdamW update in place (decoupled weight decay on every leaf,
    bias-corrected moments, eps outside the square root) at the
    configuration's ``lr`` and ``weight_decay``."""
    lr, wd = opt["lr"], opt["weight_decay"]
    (b1, b2), eps = ADAMW_BETAS, ADAMW_EPS
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * wd)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(forward, params0: dict, batches, opt: dict, block: int,
                masks=None) -> dict:
    """``len(batches)`` train steps of ``forward(params, images, masks)``
    from ``params0``, each over its batch in blocks of ``block`` images
    (gradients summed over the blocks, the loss a mean over the batch).
    Blocks are exact only for a model that treats each image apart; for one
    whose layers couple the images of a batch (BatchNorm in training), the
    caller passes the batch, which is then one block. Such a reference has
    to keep its own memory within the card: where its whole batch does not
    fit, it must chunk its per-image parts itself (attention is per image,
    so chunking it is exact).
    ``masks[s]`` is the list of per-image stochastic-depth multipliers of
    step ``s``, in call order, or None. Returns the loss of every step,
    every leaf's first gradient and its change over all the steps (on the
    host)."""
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    state: dict = {}
    losses, first = [], None
    for s, (images, labels) in enumerate(batches):
        batch = images.shape[0]
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        total = 0.0
        for lo in range(0, batch, block):
            hi = min(lo + block, batch)
            leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            step_masks = None if masks is None else [m[lo:hi] for m in masks[s]]
            logits = forward(leaves, images[lo:hi].float(), step_masks)
            loss = F.cross_entropy(logits.float(), labels[lo:hi], reduction="sum") / batch
            names = list(leaves)
            got = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            for k, g in zip(names, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        if s == 0:
            first = {k: g.cpu() for k, g in grads.items()}
        with torch.no_grad():
            adamw_(params, grads, state, s + 1, opt)
    deltas = {k: (params[k] - params0[k].float()).cpu() for k in params}
    return {"losses": losses, "grads": first, "deltas": deltas}


def sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0, device=None):
    """The fixed 2-D sincos position table ``[h·w, dim]`` (ref
    simple_vit.py:15-28): (sin x, cos x, sin y, cos y) over ``dim // 4``
    frequencies."""
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    omega = torch.arange(dim // 4, device=device, dtype=torch.float32) / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = y.reshape(-1)[:, None].float() * omega[None, :]
    x = x.reshape(-1)[:, None].float() * omega[None, :]
    return torch.cat((torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)), dim=1)


def patches(x, ph: int, pw: int):
    """NHWC images → ``[B, H/ph, W/pw, ph·pw·C]``, each patch flattened in
    (row, column, channel) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // ph, w // pw, ph * pw * c)


def lecun_std(shape) -> float:
    """1 / √fan_in of a weight kept ``[out, in, ...]``."""
    return 1.0 / math.sqrt(math.prod(shape[1:]))
