"""Plain float32 SimpleViT (Beyer et al. 2022, "Better plain ViT baselines for
ImageNet-1k", arXiv:2205.01580; ref simple_vit.py:100-149): patch
embedding, fixed 2-D sincos positions, pre-norm blocks of multi-head
attention (no biases in q/k/v or out) and a GELU MLP, mean pooling, a
LayerNorm and the head. Parameters by the port's state_dict names, taken
as data; images NHWC.
"""

from __future__ import annotations

from .common import attend, exact, gelu, layer_norm, linear, patches, sincos_2d


def param_names(cfg: dict) -> set[str]:
    names = {"to_patch_embedding.proj.weight", "to_patch_embedding.proj.bias",
             "head_norm.weight", "head_norm.bias", "linear_head.weight", "linear_head.bias"}
    for i in range(cfg["depth"]):
        a, f = f"transformer.layers_{i}_attn", f"transformer.layers_{i}_ff"
        names |= {f"{a}.norm.weight", f"{a}.norm.bias", f"{a}.to_qkv.weight",
                  f"{a}.to_out.weight", f"{f}.norm.weight", f"{f}.norm.bias",
                  f"{f}.fc1.weight", f"{f}.fc1.bias", f"{f}.fc2.weight", f"{f}.fc2.bias"}
    return names


def drop_rates(cfg: dict) -> list[float]:
    """SimpleViT has no stochastic depth."""
    return []


def forward(p: dict, images, cfg: dict, robust: bool, rnd=exact, masks=None):
    ps, dim, heads, dh = cfg["patch_size"], cfg["dim"], cfg["heads"], cfg["dim_head"]
    sched = cfg["sinkhorn"]
    x = patches(images, ps, ps)
    x = linear(x, p["to_patch_embedding.proj.weight"], p["to_patch_embedding.proj.bias"], rnd)
    b, gh, gw, _ = x.shape
    x = x.reshape(b, gh * gw, dim) + sincos_2d(gh, gw, dim, device=x.device)[None]
    n = gh * gw
    for i in range(cfg["depth"]):
        a, f = f"transformer.layers_{i}_attn", f"transformer.layers_{i}_ff"
        h = layer_norm(x, p[f"{a}.norm.weight"], p[f"{a}.norm.bias"])
        q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2)
                   for t in linear(h, p[f"{a}.to_qkv.weight"], None, rnd).chunk(3, dim=-1))
        o = attend(q, k, v, dh ** -0.5, robust, rnd=rnd, iters=sched["iters"],
                   final_row=sched["final_row_norm"])
        x = linear(o.transpose(1, 2).reshape(b, n, heads * dh), p[f"{a}.to_out.weight"],
                   None, rnd) + x
        h = layer_norm(x, p[f"{f}.norm.weight"], p[f"{f}.norm.bias"])
        h = gelu(linear(h, p[f"{f}.fc1.weight"], p[f"{f}.fc1.bias"], rnd), cfg)
        x = linear(h, p[f"{f}.fc2.weight"], p[f"{f}.fc2.bias"], rnd) + x
    x = layer_norm(x.mean(dim=1), p["head_norm.weight"], p["head_norm.bias"])
    return linear(x, p["linear_head.weight"], p["linear_head.bias"], rnd)


def train_flops_per_image(cfg: dict) -> float:
    """Analytic train FLOPs of one image (``bench.py``'s count, copied from
    ``chip_smoke.py::vit_train_flops_per_image``): the patch embedding, per
    block the q/k/v and out projections, q·kᵀ, attention·v and the MLP,
    and the head; the backward taken as twice the forward. Norms,
    activations and the Sinkhorn passes are not counted."""
    image, patch, dim = cfg["image_size"], cfg["patch_size"], cfg["dim"]
    mlp, classes = cfg["mlp_dim"], cfg["num_classes"]
    n = (image // patch) ** 2
    per_block = (2 * n * dim * (3 * dim) + 2 * n * n * dim + 2 * n * n * dim
                 + 2 * n * dim * dim + 2 * n * dim * mlp * 2)
    fwd = n * 2 * (patch * patch * cfg["channels"]) * dim + cfg["depth"] * per_block \
        + 2 * dim * classes
    return 3 * fwd
