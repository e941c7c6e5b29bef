"""Plain float32 Swin Transformer v1 (Liu et al. 2021, arXiv:2103.14030; the
torchvision layout, ref swin.py:584-759): a 4×4 patch embedding and its
LayerNorm, four stages of blocks with window attention (a learned
relative-position bias table, the cyclic shift on every second block and
its -100 mask), a GELU MLP and per-image stochastic depth, patch merging
between stages, a last LayerNorm, mean pooling and the head. Parameters by
the port's state_dict names, taken as data; images NHWC.
"""

from __future__ import annotations

import math

import torch

from .common import attend, exact, gelu, layer_norm, linear, patches


def _blocks(cfg: dict):
    """(stage, block, dim, heads, stochastic-depth rate) of every block."""
    total, out, i = sum(cfg["depths"]), [], 0
    for s, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            rate = cfg["stochastic_depth"] * i / max(total - 1, 1)
            out.append((s, j, cfg["embed_dim"] * 2 ** s, cfg["heads"][s], rate))
            i += 1
    return out


def param_names(cfg: dict) -> set[str]:
    names = {"patch_embed.weight", "patch_embed.bias", "patch_norm.weight", "patch_norm.bias",
             "norm.weight", "norm.bias", "head.weight", "head.bias"}
    for s, j, _, _, _ in _blocks(cfg):
        b = f"stage{s}_block{j}"
        names |= {f"{b}.{n}" for n in (
            "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.qkv.weight",
            "attn.qkv.bias", "attn.relative_position_bias_table", "attn.proj.weight",
            "attn.proj.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
            "mlp.fc2.bias")}
    for s in range(len(cfg["depths"]) - 1):
        names |= {f"downsample{s}.norm.weight", f"downsample{s}.norm.bias",
                  f"downsample{s}.reduction.weight"}
    return names


def drop_rates(cfg: dict) -> list[float]:
    """The rate of every stochastic-depth draw of one forward, in call
    order: each block with a rate above 0 draws for its attention branch,
    then for its MLP branch."""
    return [r for *_, r in _blocks(cfg) if r > 0 for _ in range(2)]


def relative_index(w: int) -> torch.Tensor:
    """``[w²·w²]`` index into the ``(2w-1)²`` bias table (ref swin.py:321-343)."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def shift_mask(side: int, w: int, shift: int) -> torch.Tensor:
    """``[nW, w², w²]`` additive mask, -100 between tokens that the cyclic
    shift brought together from different regions (ref swin.py:202-237)."""
    img = torch.zeros(side, side)
    cuts = ((0, side - w), (side - w, side - shift), (side - shift, side))
    for r, (h0, h1) in enumerate(cuts):
        for c, (w0, w1) in enumerate(cuts):
            img[h0:h1, w0:w1] = 3 * r + c
    img = img.reshape(side // w, w, side // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    return torch.where(img[:, None, :] != img[:, :, None], -100.0, 0.0)


def _window_attention(p, pre, x, heads, w, shift, robust, rnd, sched):
    b, side, _, c = x.shape
    dh = c // heads
    if side % w:
        raise ValueError(f"the reference takes maps that are a multiple of the window, not {side}")
    if w >= side:
        shift = 0
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nw = (side // w) ** 2
    xw = x.reshape(b, side // w, w, side // w, w, c).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(b * nw, w * w, c)
    qkv = linear(xw, p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"], rnd)
    q, k, v = qkv.reshape(b * nw, w * w, 3, heads, dh).permute(2, 0, 3, 1, 4)
    n = w * w
    table = p[f"{pre}.relative_position_bias_table"]
    bias = table[relative_index(w).to(table.device)].reshape(n, n, heads).permute(2, 0, 1)
    bias = bias[None, None]                                  # [1, 1, H, N, N]
    if shift:
        bias = bias + shift_mask(side, w, shift).to(x.device)[None, :, None]
    q, k, v = (t.reshape(b, nw, heads, n, dh) for t in (q, k, v))
    o = attend(q, k, v, dh ** -0.5, robust, bias=bias, rnd=rnd, iters=sched["iters"],
               final_row=sched["final_row_norm"])
    o = o.transpose(2, 3).reshape(b * nw, n, c)
    o = linear(o, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"], rnd)
    o = o.reshape(b, side // w, side // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    o = o.reshape(b, side, side, c)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o


def forward(p: dict, images, cfg: dict, robust: bool, rnd=exact, masks=None):
    ps, w = cfg["patch_size"], cfg["window"]
    x = patches(images, ps, ps)
    weight = p["patch_embed.weight"].permute(0, 2, 3, 1).reshape(cfg["embed_dim"], -1)
    x = linear(x, weight, p["patch_embed.bias"], rnd)
    x = layer_norm(x, p["patch_norm.weight"], p["patch_norm.bias"])
    draws = iter(masks or [])
    blocks = _blocks(cfg)
    for idx, (s, j, _, heads, rate) in enumerate(blocks):
        pre = f"stage{s}_block{j}"
        drop = ((lambda t: t * next(draws).reshape(-1, 1, 1, 1)) if rate > 0 and masks
                else (lambda t: t))
        h = layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"])
        x = x + drop(_window_attention(p, f"{pre}.attn", h, heads, w,
                                       0 if j % 2 == 0 else w // 2, robust, rnd,
                                       cfg["sinkhorn"]))
        h = layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"])
        h = gelu(linear(h, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"], rnd), cfg)
        x = x + drop(linear(h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"], rnd))
        last = idx + 1 == len(blocks) or blocks[idx + 1][0] != s
        if last and s < len(cfg["depths"]) - 1:
            d = f"downsample{s}"
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1)
            x = layer_norm(x, p[f"{d}.norm.weight"], p[f"{d}.norm.bias"])
            x = linear(x, p[f"{d}.reduction.weight"], None, rnd)
    x = layer_norm(x, p["norm.weight"], p["norm.bias"]).mean(dim=(1, 2))
    return linear(x, p["head.weight"], p["head.bias"], rnd)


def train_flops_per_image(cfg: dict) -> float:
    """Analytic train FLOPs of one image: 3 × 2 × the forward multiply-adds
    (copied from ``chip_smoke.py::swin_fwd_macs_per_image``, the unit of
    torchvision's published 4.49 "GFLOPS" for Swin-T): the patch
    convolution, per block q/k/v, q·kᵀ and attention·v over the padded
    windows, the projection and the MLP, the patch mergings and the head.
    Norms, the bias, activations and the Sinkhorn passes are not counted."""
    h = cfg["image_size"] // cfg["patch_size"]
    embed, w, mlp = cfg["embed_dim"], cfg["window"], cfg["mlp_ratio"]
    macs = h * h * cfg["patch_size"] ** 2 * cfg["channels"] * embed
    for i, depth in enumerate(cfg["depths"]):
        c = embed * 2 ** i
        tokens, padded = h * h, (math.ceil(h / w) * w) ** 2
        per_block = (padded * c * 3 * c + 2 * padded * w * w * c + padded * c * c
                     + 2 * tokens * c * mlp * c)
        macs += depth * per_block
        if i < len(cfg["depths"]) - 1:
            h = math.ceil(h / 2)
            macs += h * h * 4 * c * 2 * c
    macs += embed * 2 ** (len(cfg["depths"]) - 1) * cfg["num_classes"]
    return 3 * 2 * macs

