"""Architecture registry: name → constructor (counterpart of
``noise_robust_vit_tpu/models/factory.py``; the port's entries so far are
``simple_vit``, ``simple_vit_b16``, the Swin v1/v2 builders, the torchvision-style
``vit_b_16/b_32/l_16/l_32/h_14``, the LeViT builders, with ``levit`` for
LeViT-128S, ``cait``, ``cvt_13`` and ``mobile_vit_xs``). Every entry accepts
``(num_classes, image_size, robust, dtype, device)``.
``create_model`` builds on the card unless ``device`` names another (it
raises when there is no card), draws the initial weights from a
``torch.Generator`` seeded with ``seed``, and gives the stochastic-depth
layers (``DropPath``, CaiT's whole-layer dropout) a generator seeded with
``seed + 1``. On the meta device nothing is drawn."""

from __future__ import annotations

from typing import Callable

import torch

from ..utils import resolve_device
from . import levit, swin, vision_transformer
from .cait import CaiT, _Transformer as _CaiTStage
from .cvt import CvT
from .layers import DropPath, init_params
from .mobile_vit import MobileViT
from .simple_vit import SimpleViT

_REGISTRY: dict[str, Callable] = {}

__all__ = ["create_model", "register_model"]


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def create_model(name: str, *, num_classes: int, image_size: int = 224,
                 robust: bool = False, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None, seed: int = 0,
                 **kwargs) -> torch.nn.Module:
    if name not in _REGISTRY:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    device = resolve_device(device)
    model = _REGISTRY[name](num_classes=num_classes, image_size=image_size,
                            robust=robust, dtype=dtype, device=device, **kwargs)
    if device.type == "meta":
        return model
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    init_params(model, generator)
    drop_generator = torch.Generator(device=device)
    drop_generator.manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, (DropPath, _CaiTStage)):
            m.generator = drop_generator
    return model


@register_model("simple_vit")
def _simple_vit(num_classes, image_size, robust, dtype, device=None, **kw):
    """The CPU-sized baseline config (depth-6/dim-512/patch-4 @32px), scaled
    by image size (JAX factory.py:292)."""
    return SimpleViT(
        image_size=image_size,
        patch_size=kw.pop("patch_size", 4 if image_size <= 64 else 16),
        num_classes=num_classes,
        dim=kw.pop("dim", 512),
        depth=kw.pop("depth", 6),
        heads=kw.pop("heads", 8),
        mlp_dim=kw.pop("mlp_dim", 1024),
        robust=robust, dtype=dtype, device=device, **kw,
    )


@register_model("simple_vit_b16")
def _simple_vit_b16(num_classes, image_size, robust, dtype, device=None, **kw):
    """SimpleViT-B/16, the flagship throughput config (JAX factory.py:310)."""
    return SimpleViT(
        image_size=image_size, patch_size=16, num_classes=num_classes,
        dim=768, depth=12, heads=12, mlp_dim=3072,
        robust=robust, dtype=dtype, device=device, **kw,
    )


for _name in ("swin_t", "swin_s", "swin_b", "swin_v2_t", "swin_v2_s", "swin_v2_b"):
    register_model(_name)(getattr(swin, _name))
for _name in ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"):
    register_model(_name)(getattr(vision_transformer, _name))
for _name in ("LeViT_128S", "LeViT_128", "LeViT_192", "LeViT_256", "LeViT_384"):
    register_model(_name)(getattr(levit, _name))
register_model("levit")(levit.LeViT_128S)  # the fork's arch switch name


@register_model("cait")
def _cait(num_classes, image_size, robust, dtype, device=None, **kw):
    """CaiT as the JAX factory builds it (JAX factory.py:265-273): patch 16
    (4 at ≤ 64 px), dim 512, depth 6, cls_depth 2, 8 heads of 64, MLP 1024,
    no dropout."""
    return CaiT(
        image_size=image_size, patch_size=kw.pop("patch_size", 4 if image_size <= 64 else 16),
        num_classes=num_classes, dim=kw.pop("dim", 512), depth=kw.pop("depth", 6),
        cls_depth=kw.pop("cls_depth", 2), heads=kw.pop("heads", 8),
        mlp_dim=kw.pop("mlp_dim", 1024), robust=robust, dtype=dtype, device=device, **kw,
    )


@register_model("cvt_13")
def _cvt_13(num_classes, image_size, robust, dtype, device=None, **kw):
    """CvT-13 as the JAX factory builds it (JAX factory.py:137-141: the
    ``CvT`` defaults, dims 64/192/384, heads 1/3/6, depths 1/2/10, dim_head
    64, kv stride 2, no dropout). CvT takes any image size, so
    ``image_size`` is not used, as in JAX."""
    return CvT(num_classes=num_classes, robust=robust, dtype=dtype, device=device, **kw)


@register_model("mobile_vit_xs")
def _mobile_vit_xs(num_classes, image_size, robust, dtype, device=None, **kw):
    """MobileViT-XS as the JAX factory builds it (JAX factory.py:192-199):
    dims 96/120/144, channels (16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384),
    depths 2/4/3, expansion 4, kernel 3, patch 2×2. MobileViT takes any
    image side that is a multiple of 64, so ``image_size`` is not used, as
    in JAX."""
    return MobileViT(
        dims=kw.pop("dims", (96, 120, 144)),
        channels=kw.pop("channels", (16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384)),
        num_classes=num_classes, robust=robust, dtype=dtype, device=device, **kw,
    )
