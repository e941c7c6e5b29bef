"""Plain float32 LeViT (Graham et al. 2021, "LeViT: a Vision Transformer in
ConvNet's Clothing for Faster Inference", arXiv:2104.01136) as the fork
builds it (ref levit.py, from facebookresearch/LeViT): a stem of four
stride-2 3×3 Conv-BN layers with hard-swish between them, the map flattened
to tokens row by row; three stages of residual blocks, each an attention
and an MLP made of Linear+BN pairs; between stages a subsampling attention
whose queries sit on every second position of every second row and whose
values are wider, followed by a residual MLP; a mean pool, BatchNorm and
the head. Parameters by the port's state_dict names, taken as data; images
NHWC.

Attention (ref levit.py:198-296): one Linear+BN gives each head's q and k
(``key_dim`` wide) and v (``attn_ratio × key_dim`` wide); the logits
``scale·q·kᵀ`` get a learned bias gathered from a table ``[heads,
offsets]`` by the absolute offset between the two positions (ref
levit.py:225-238; the subsample's by the query's position times the
stride, ref :336-355), numbered in the order the offsets first occur;
hard-swish before the output Linear+BN. The MLP is Linear+BN, hard-swish,
Linear+BN.

BatchNorm is in training mode: each channel by the batch's mean and biased
variance over its images (and tokens or positions), eps 1e-5; the running
statistics are not read. So the model couples the images of a batch, and
its reference steps take the batch whole.

Departures from the paper, all the fork's or the benchmark's:

- no distillation head (the fork's ``distillation=False``): one head;
- no stochastic depth (drop path 0, as published for LeViT-128S);
- a bias on every Conv and Linear before a BatchNorm (the fork's
  ``use_bias=True``; the published ``Conv2d_BN`` and ``Linear_BN`` have
  none): BatchNorm in training removes it, so its true gradient is 0;
- the bias tables and the BatchNorm scales are parameters like any other:
  the benchmark's weight draw, not LeViT's zeros, sets them (the
  configuration's ``assumed``);
- the Sinkhorn rewrites run as the equivalent scaling-vector iteration
  with the program's guarded reciprocal (the JAX package's
  ``sinkhorn_scalings``; ``recip``): a sum of exactly 0 scales by 1 and a
  live sum is clamped at 1e-8, with the gradient the program's backward
  gives it. The literal rewrites divide by zero where a key receives no
  mass in float32, and under the benchmark's weight draw LeViT-128S
  starves keys so on some seeds (logits to ±400, column sums to 0 in its
  last stage).
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .common import exact, linear

# a layer (BatchNorm in training) computes over the images of the batch
COUPLES_IMAGES = True

BN_EPS = 1e-5
STEM_LAYERS = 4
# the program's floor on a live row or column sum of the Sinkhorn chain
SUM_FLOOR = 1e-8


def blocks(cfg: dict) -> list[tuple]:
    """The residual and subsampling branches in call order: ``(name,
    kind, sizes)`` with kind "attn", "mlp" or "sub"; ``side`` is the token
    grid's side where the branch runs (the subsample's keys'; ``side_`` its
    queries')."""
    out, blk = [], 0
    side = cfg["image_size"] // cfg["patch_size"]
    subs = cfg["subsample"] + [None]
    for i, (dim, heads, depth, sub) in enumerate(zip(cfg["embed_dim"], cfg["heads"],
                                                     cfg["depth"], subs)):
        for _ in range(depth):
            out.append((f"block{blk}_attn", "attn",
                        dict(dim=dim, heads=heads, key_dim=cfg["key_dim"],
                             dv=cfg["attn_ratio"] * cfg["key_dim"], side=side)))
            out.append((f"block{blk}_mlp", "mlp",
                        dict(dim=dim, hidden=dim * cfg["mlp_ratio"], side=side)))
            blk += 1
        if sub is not None:
            side_ = (side - 1) // sub["stride"] + 1
            nxt = cfg["embed_dim"][i + 1]
            out.append((f"downsample{i}", "sub",
                        dict(dim=dim, out=nxt, heads=sub["heads"], key_dim=sub["key_dim"],
                             dv=sub["attn_ratio"] * sub["key_dim"], stride=sub["stride"],
                             side=side, side_=side_)))
            out.append((f"downsample{i}_mlp", "mlp",
                        dict(dim=nxt, hidden=nxt * sub["mlp_ratio"], side=side_)))
            side = side_
    return out


def _linear_bn(pre: str) -> set[str]:
    return {f"{pre}.{n}" for n in ("c.weight", "c.bias", "bn.weight", "bn.bias")}


def param_names(cfg: dict) -> set[str]:
    names = {"head_bn.weight", "head_bn.bias", "head.weight", "head.bias"}
    for i in range(STEM_LAYERS):
        names |= _linear_bn(f"stem{i}")
    for name, kind, _ in blocks(cfg):
        if kind == "attn":
            names |= _linear_bn(f"{name}.qkv") | _linear_bn(f"{name}.proj")
        elif kind == "sub":
            names |= (_linear_bn(f"{name}.kv") | _linear_bn(f"{name}.q")
                      | _linear_bn(f"{name}.proj"))
        else:
            names |= _linear_bn(f"{name}.fc1") | _linear_bn(f"{name}.fc2")
        if kind != "mlp":
            names.add(f"{name}.attention_biases")
    return names


def drop_rates(cfg: dict) -> list[float]:
    """LeViT-128S has no stochastic depth."""
    return []


def bias_index(side: int, side_: int, stride: int) -> torch.Tensor:
    """``[side_², side²]`` index into the bias table: each (query, key)
    pair's absolute offset ``(|qy·stride − ky|, |qx·stride − kx|)``,
    numbered in the order the offsets first occur (ref levit.py:225-238
    with side_ = side and stride 1, :336-355)."""
    keys = list(itertools.product(range(side), range(side)))
    numbers: dict[tuple[int, int], int] = {}
    rows = []
    for qy, qx in itertools.product(range(side_), range(side_)):
        rows.append([numbers.setdefault((abs(qy * stride - ky), abs(qx * stride - kx)),
                                        len(numbers)) for ky, kx in keys])
    return torch.tensor(rows)


class _Recip(torch.autograd.Function):
    """``1 / s``, where a sum of exactly 0 gives 1 (the row or column stays
    0) and a live sum is clamped at ``SUM_FLOOR``. The gradient is
    ``−(1/s)²`` at that value, clamped or not, as the program's (and the JAX
    package's) hand-written backward of the chain takes it; where the floor
    holds a sum, the clamp's own derivative would be 0."""

    @staticmethod
    def forward(ctx, s):
        r = torch.where(s == 0, torch.ones_like(s), 1.0 / s.clamp_min(SUM_FLOOR))
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return -g * r * r


recip = _Recip.apply


def attention_weights(logits, robust: bool, iters: int = 3, final_row: bool = True):
    """Row softmax, then with ``robust`` ``iters`` times a row and a column
    normalization and a last row normalization, as the scalings ``a``
    (rows) and ``b`` (columns) of ``diag(a)·softmax·diag(b)``: the same
    matrix as the rewrites wherever no sum falls under ``SUM_FLOOR``."""
    attn = torch.softmax(logits, dim=-1)
    if not robust:
        return attn
    b = torch.ones_like(attn[..., 0, :])
    a = torch.ones_like(attn[..., 0])
    for _ in range(iters):
        a = recip((attn * b[..., None, :]).sum(-1))
        b = recip((attn * a[..., :, None]).sum(-2))
    if final_row:
        a = recip((attn * b[..., None, :]).sum(-1))
    return attn * a[..., :, None] * b[..., None, :]


def batch_norm(x, w, b):
    """Over the last axis, with the batch's statistics over every other
    axis (biased variance)."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    var = ((x - mean) ** 2).mean(dim=dims)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def linear_bn(p, pre, x, rnd):
    return batch_norm(linear(x, p[f"{pre}.c.weight"], p[f"{pre}.c.bias"], rnd),
                      p[f"{pre}.bn.weight"], p[f"{pre}.bn.bias"])


def stem(p, x, rnd):
    """Four 3×3 stride-2 Conv-BN layers, 1 padded on each side, hard-swish
    after each but the last; NHWC in and out."""
    for i in range(STEM_LAYERS):
        w = p[f"stem{i}.c.weight"]
        y = F.conv2d(rnd(x.permute(0, 3, 1, 2)), rnd(w), p[f"stem{i}.c.bias"], 2, 1)
        x = batch_norm(y.permute(0, 2, 3, 1), p[f"stem{i}.bn.weight"], p[f"stem{i}.bn.bias"])
        if i < STEM_LAYERS - 1:
            x = F.hardswish(x)
    return x


def _attend(p, name, q, k, v, s: dict, cfg: dict, robust: bool, rnd):
    """``weights(scale·q·kᵀ + bias) · v`` for each head, then hard-swish and
    the output Linear+BN; q ``[B, H, NQ, key_dim]``, k and v ``[B, H, N,
    ·]``."""
    idx = bias_index(s["side"], s.get("side_", s["side"]), s.get("stride", 1))
    logits = torch.matmul(rnd(q), rnd(k).transpose(-1, -2)) * s["key_dim"] ** -0.5
    logits = logits + p[f"{name}.attention_biases"][:, idx.to(q.device)]
    sched = cfg["sinkhorn"]
    attn = attention_weights(logits, robust, sched["iters"], sched["final_row_norm"])
    o = torch.matmul(rnd(attn), rnd(v))
    b, h, nq, dv = o.shape
    o = o.transpose(1, 2).reshape(b, nq, h * dv)
    return linear_bn(p, f"{name}.proj", F.hardswish(o), rnd)


def attention(p, name, x, s: dict, cfg: dict, robust: bool, rnd):
    b, n, _ = x.shape
    h, kd, dv = s["heads"], s["key_dim"], s["dv"]
    qkv = linear_bn(p, f"{name}.qkv", x, rnd).reshape(b, n, h, 2 * kd + dv)
    q, k, v = (t.transpose(1, 2) for t in qkv.split([kd, kd, dv], dim=-1))
    return _attend(p, name, q, k, v, s, cfg, robust, rnd)


def subsample(p, name, x, s: dict, cfg: dict, robust: bool, rnd):
    b, n, c = x.shape
    h, kd, dv = s["heads"], s["key_dim"], s["dv"]
    kv = linear_bn(p, f"{name}.kv", x, rnd).reshape(b, n, h, kd + dv)
    k, v = (t.transpose(1, 2) for t in kv.split([kd, dv], dim=-1))
    st = s["stride"]
    xs = x.reshape(b, s["side"], s["side"], c)[:, ::st, ::st].reshape(b, -1, c)
    q = linear_bn(p, f"{name}.q", xs, rnd).reshape(b, -1, h, kd).transpose(1, 2)
    return _attend(p, name, q, k, v, s, cfg, robust, rnd)


def mlp(p, name, x, rnd):
    return linear_bn(p, f"{name}.fc2", F.hardswish(linear_bn(p, f"{name}.fc1", x, rnd)), rnd)


def forward(p: dict, images, cfg: dict, robust: bool, rnd=exact, masks=None):
    x = stem(p, images, rnd)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    for name, kind, s in blocks(cfg):
        if kind == "attn":
            x = x + attention(p, name, x, s, cfg, robust, rnd)
        elif kind == "mlp":
            x = x + mlp(p, name, x, rnd)
        else:
            x = subsample(p, name, x, s, cfg, robust, rnd)
    x = batch_norm(x.mean(dim=1), p["head_bn.weight"], p["head_bn.bias"])
    return linear(x, p["head.weight"], p["head.bias"], rnd)


def train_flops_per_image(cfg: dict) -> float:
    """Analytic train FLOPs of one image: 3 × 2 × the forward multiply-adds
    of the stem's convolutions, every Linear, q·kᵀ and attention·v of both
    attention types, and the head (0.30428 G at 224 px for LeViT-128S; the
    paper gives 305 M). BatchNorm, hard-swish, the bias gather and the
    Sinkhorn passes are not counted."""
    size, cin, macs = cfg["image_size"], cfg["channels"], 0
    c = cfg["embed_dim"][0]
    for ch in (c // 8, c // 4, c // 2, c):
        size = (size + 2 - 3) // 2 + 1
        macs += size * size * 9 * cin * ch
        cin = ch
    for _, kind, s in blocks(cfg):
        n = s["side"] ** 2
        if kind == "attn":
            h, kd, dv = s["heads"], s["key_dim"], s["dv"]
            macs += (n * s["dim"] * h * (2 * kd + dv) + h * n * n * (kd + dv)
                     + n * h * dv * s["dim"])
        elif kind == "sub":
            n_, h, kd, dv = s["side_"] ** 2, s["heads"], s["key_dim"], s["dv"]
            macs += (n * s["dim"] * h * (kd + dv) + n_ * s["dim"] * h * kd
                     + h * n_ * n * (kd + dv) + n_ * h * dv * s["out"])
        else:
            macs += 2 * n * s["dim"] * s["hidden"]
    macs += cfg["embed_dim"][-1] * cfg["num_classes"]
    return 3 * 2 * macs
