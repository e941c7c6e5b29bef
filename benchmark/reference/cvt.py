"""Plain float32 CvT (Wu et al. 2021, "CvT: Introducing Convolutions to Vision
Transformers", arXiv:2103.15808, Table 2) as the fork builds it (ref cvt.py,
from lucidrains/vit-pytorch): three stages, each a strided convolutional
token embedding and a channel LayerNorm, then pre-norm blocks of attention
whose q and k/v projections are a depthwise convolution, BatchNorm and a 1×1
convolution (k/v with a stride, which reduces the keys), and a feed-forward
of two 1×1 convolutions around a GELU; a global mean pool and the head.
Parameters by the port's state_dict names, taken as data; images NHWC.

Departures from the paper, all the fork's:

- no class token in stage 3: the head mean-pools the last map;
- no stochastic depth;
- the q/k/v projections have no bias;
- every convolution pads ``kernel // 2`` on each side (3 around the 7×7
  embedding, 1 around the 3×3 ones), strided ones included.

The channel LayerNorm (``g``, ``b``) normalises each position over its
channels with the biased variance, eps 1e-5. BatchNorm is in training mode:
each channel by the batch's mean and biased variance over its images and
positions, eps 1e-5; the running statistics are not read. So the model
couples the images of a batch, and its reference steps take the batch whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attend, exact, gelu, layer_norm, linear

# a layer (BatchNorm in training) computes over the images of the batch
COUPLES_IMAGES = True

STAGE_KEYS = ("emb_dim", "emb_kernel", "emb_stride", "proj_kernel", "kv_proj_stride",
              "heads", "depth", "mlp_mult")
BN_EPS = 1e-5


def stages(cfg: dict) -> list[dict]:
    """Each stage's sizes, from the configuration's per-stage lists."""
    return [{k: cfg[k][i] for k in STAGE_KEYS} for i in range(len(cfg["depth"]))]


def param_names(cfg: dict) -> set[str]:
    names = {"head.weight", "head.bias"}
    for s, st in enumerate(stages(cfg), 1):
        names |= {f"s{s}_embed.weight", f"s{s}_embed.bias", f"s{s}_norm.g", f"s{s}_norm.b"}
        for d in range(st["depth"]):
            p = f"s{s}_b{d}_"
            names |= {p + n for n in ("norm1.g", "norm1.b", "norm2.g", "norm2.b",
                                      "attn.to_out.weight", "attn.to_out.bias", "ff1.weight",
                                      "ff1.bias", "ff2.weight", "ff2.bias")}
            names |= {f"{p}attn.{proj}.{n}" for proj in ("to_q", "to_kv")
                      for n in ("dw.weight", "bn.weight", "bn.bias", "pw.weight")}
    return names


def drop_rates(cfg: dict) -> list[float]:
    """The fork's CvT has no stochastic depth."""
    return []


def conv(x, w, b, stride: int, rnd=exact, groups: int = 1):
    """NHWC → NHWC through an OIHW kernel, ``kernel // 2`` padded on each
    side."""
    y = F.conv2d(rnd(x.permute(0, 3, 1, 2)), rnd(w), b, stride, w.shape[-1] // 2, 1, groups)
    return y.permute(0, 2, 3, 1)


def batch_norm(x, w, b):
    """Over the last axis, with the batch's statistics (biased variance)."""
    mean = x.mean(dim=(0, 1, 2))
    var = ((x - mean) ** 2).mean(dim=(0, 1, 2))
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def projection(p, pre, x, stride: int, rnd):
    """Depthwise convolution → BatchNorm → 1×1 convolution, no biases."""
    h = conv(x, p[f"{pre}.dw.weight"], None, stride, rnd, groups=x.shape[-1])
    h = batch_norm(h, p[f"{pre}.bn.weight"], p[f"{pre}.bn.bias"])
    return conv(h, p[f"{pre}.pw.weight"], None, 1, rnd)


def attention(p, pre, x, st: dict, cfg: dict, robust: bool, rnd):
    b, h, w, _ = x.shape
    heads, dh = st["heads"], cfg["dim_head"]
    q = projection(p, f"{pre}.to_q", x, 1, rnd)
    k, v = projection(p, f"{pre}.to_kv", x, st["kv_proj_stride"], rnd).chunk(2, dim=-1)
    q, k, v = (t.reshape(b, -1, heads, dh).transpose(1, 2) for t in (q, k, v))
    sched = cfg["sinkhorn"]
    o = attend(q, k, v, dh ** -0.5, robust, rnd=rnd, iters=sched["iters"],
               final_row=sched["final_row_norm"])
    o = o.transpose(1, 2).reshape(b, h, w, heads * dh)
    return conv(o, p[f"{pre}.to_out.weight"], p[f"{pre}.to_out.bias"], 1, rnd)


def forward(p: dict, images, cfg: dict, robust: bool, rnd=exact, masks=None):
    x = images
    for s, st in enumerate(stages(cfg), 1):
        x = conv(x, p[f"s{s}_embed.weight"], p[f"s{s}_embed.bias"], st["emb_stride"], rnd)
        x = layer_norm(x, p[f"s{s}_norm.g"], p[f"s{s}_norm.b"])
        for d in range(st["depth"]):
            pre = f"s{s}_b{d}_"
            h = layer_norm(x, p[pre + "norm1.g"], p[pre + "norm1.b"])
            x = x + attention(p, pre + "attn", h, st, cfg, robust, rnd)
            h = layer_norm(x, p[pre + "norm2.g"], p[pre + "norm2.b"])
            h = gelu(conv(h, p[pre + "ff1.weight"], p[pre + "ff1.bias"], 1, rnd), cfg)
            x = x + conv(h, p[pre + "ff2.weight"], p[pre + "ff2.bias"], 1, rnd)
    return linear(x.mean(dim=(1, 2)), p["head.weight"], p["head.bias"], rnd)


def train_flops_per_image(cfg: dict) -> float:
    """Analytic train FLOPs of one image: 3 × 2 × the forward multiply-adds
    of the embeddings, each block's depthwise and pointwise q and k/v
    projections, q·kᵀ and attention·v, the output projection and the
    feed-forward, and the head (4.5437 G at 224 px for CvT-13; the paper
    gives 4.5 G). Norms, activations and the Sinkhorn passes are not
    counted."""
    size, cin, macs = cfg["image_size"], cfg["channels"], 0
    for st in stages(cfg):
        dim, k, pk = st["emb_dim"], st["emb_kernel"], st["proj_kernel"]
        size = (size + 2 * (k // 2) - k) // st["emb_stride"] + 1
        n = size * size
        m = ((size + 2 * (pk // 2) - pk) // st["kv_proj_stride"] + 1) ** 2
        inner = st["heads"] * cfg["dim_head"]
        macs += n * k * k * cin * dim
        macs += st["depth"] * (n * pk * pk * dim + n * dim * inner
                               + m * pk * pk * dim + m * dim * 2 * inner
                               + 2 * n * m * inner + n * inner * dim
                               + 2 * n * dim * dim * st["mlp_mult"])
        cin = dim
    macs += cin * cfg["num_classes"]
    return 3 * 2 * macs
