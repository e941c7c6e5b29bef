"""Which op serves each robust attention site of the port's models, at the
small configs of their CPU test files and of MobileViT's, in one forward at
batch 2.

Every kernel entry (the autograd functions of the packed, biased,
streaming, square and rectangular Sinkhorn-softmax, talking-heads and fused
q/k/v kernels) and both vector forms (``dot_product_attention``'s scaling
vectors, ``sinkhorn_attention``'s normalization) are spied on, and the
sites are recorded in call order as (op, shape of the first operand). The
fused q/k/v path serves MobileViT's transformers and SimpleViT at head width
16 (its ``plain_qkv`` case, which took the vector form before the fused
kernels were ported), and no other site: every site of SimpleViT at head
width 32, Swin, LeViT, CaiT and CvT keeps the op it had.

The fused LayerNorm (``FusedLayerNormFn``) is spied on as well: it serves
the shared blocks' norms of a SimpleViT at D 128 (inside its gate), and no
site of the models whose block widths lie outside it. The
torchvision-style VisionTransformer's sites take the packed kernels, both
modes, on its 4-iteration schedule with no final row norm.
"""

import pytest
import torch

from noise_robust_vit_tpu_torch import (CaiT, CvT, LeViT, MobileViT, SimpleViT, SwinTransformer,
                                        VisionTransformer)
from noise_robust_vit_tpu_torch.ops import attention as attention_ops
from noise_robust_vit_tpu_torch.ops import sinkhorn as sinkhorn_ops
from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba
from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa
from noise_robust_vit_tpu_torch.ops.cuda import fused_ln as fl
from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss
from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa
from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th

torch.set_num_threads(1)

LEVIT_D, LEVIT_EMBED = 16, (32, 48, 64)
# name → (class, keyword arguments, image size, the sites in call order);
# the configs are those of tests/test_torch_{simple_vit,swin,levit,cait,cvt,
# mobile_vit,vision_transformer,fused_ln}.py
MODELS = {
    "simple_vit_d32": (SimpleViT, dict(image_size=32, patch_size=8, num_classes=10, dim=64,
                                       depth=2, heads=2, mlp_dim=128, dim_head=32), 32,
                       [("packed", (2, 16, 192))] * 2),
    "simple_vit_d16": (SimpleViT, dict(image_size=32, patch_size=8, num_classes=10, dim=64,
                                       depth=2, heads=2, mlp_dim=128, dim_head=16), 32,
                       [("fused", (2, 2, 16, 16))] * 2),
    "swin_v1": (SwinTransformer, dict(patch_size=(4, 4), embed_dim=16, depths=(2, 2),
                                      num_heads=(2, 2), window_size=(4, 4), num_classes=5,
                                      stochastic_depth_prob=0.0, version=1), 32,
                [("biased", (8, 2, 16, 8))] * 2 + [("biased", (2, 2, 16, 16))] * 2),
    "swin_v2": (SwinTransformer, dict(patch_size=(4, 4), embed_dim=16, depths=(2, 2),
                                      num_heads=(2, 2), window_size=(4, 4), num_classes=5,
                                      stochastic_depth_prob=0.0, version=2), 32,
                [("biased", (8, 2, 16, 8))] * 2 + [("biased", (2, 2, 16, 16))] * 2),
    "levit": (LeViT, dict(img_size=112, patch_size=16, num_classes=5, embed_dim=LEVIT_EMBED,
                          key_dim=(LEVIT_D,) * 3, depth=(1, 1, 1), num_heads=(2, 3, 4),
                          attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
                          down_ops=(("Subsample", LEVIT_D, LEVIT_EMBED[0] // LEVIT_D, 4, 2, 2),
                                    ("Subsample", LEVIT_D, LEVIT_EMBED[1] // LEVIT_D, 4, 2, 2))),
              112, [("biased", (2, 2, 49, 16)), ("rect", (2, 2, 16, 49)),
                    ("biased", (2, 3, 16, 16)), ("rect", (2, 3, 4, 16)),
                    ("biased", (2, 4, 4, 16))]),
    "cait": (CaiT, dict(image_size=32, patch_size=8, num_classes=5, dim=64, depth=2, cls_depth=1,
                        heads=4, mlp_dim=128), 32,
             [("talking_heads", (2, 4, 16, 16))] * 2 + [("vector_logits", (2, 4, 1, 17))]),
    "cvt_32": (CvT, dict(num_classes=5, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24,
                         s2_heads=1, s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1), 32,
               [("rect", (2, 1, 64, 16)), ("rect", (2, 1, 16, 4)),
                ("vector_logits", (2, 2, 4, 1))]),
    "cvt_112": (CvT, dict(num_classes=5, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24,
                          s2_heads=1, s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1), 112,
                [("streaming", (2, 1, 784, 64)), ("rect", (2, 1, 196, 49)),
                 ("rect", (2, 2, 49, 16))]),
    "mobile_vit": (MobileViT, dict(num_classes=5, dims=(16, 24, 16),
                                   channels=(8, 8, 12, 16, 16, 24, 24, 24, 24, 32, 48),
                                   depths=(1, 1, 1)), 128,
                   [("fused", (8, 4, 64, 8)), ("fused", (8, 4, 16, 8)), ("fused", (8, 4, 4, 8))]),
    "vit": (VisionTransformer, dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
                                    hidden_dim=64, mlp_dim=128, num_classes=10), 32,
            [("packed", (2, 17, 192))] * 2),
    "simple_vit_fused_ln": (SimpleViT, dict(image_size=32, patch_size=8, num_classes=10, dim=128,
                                            depth=2, heads=2, mlp_dim=128, dim_head=32), 32,
                            [("fused_ln", (2, 16, 128)), ("packed", (2, 16, 192)),
                             ("fused_ln", (2, 16, 128))] * 2),
}
# ops that serve vanilla sites too
BOTH_MODES = {"packed", "fused_ln"}


@pytest.fixture
def sites(monkeypatch):
    """Record (op, first operand's shape) of every attention op called."""
    calls = []

    def spy(owner, attr, label):
        real = getattr(owner, attr)

        def wrapper(x, *args, **kwargs):
            calls.append((label, tuple(x.shape)))
            return real(x, *args, **kwargs)

        monkeypatch.setattr(owner, attr, wrapper)

    for owner, label in ((pa.PackedAttention, "packed"), (ba.BiasedAttention, "biased"),
                         (sa.StreamingAttention, "streaming"), (ss.SinkhornSoftmax, "square"),
                         (ss.SinkhornSoftmaxRect, "rect"),
                         (th.TalkingHeadsSinkhorn, "talking_heads"),
                         (fa.FusedAttention, "fused"), (fl.FusedLayerNormFn, "fused_ln")):
        spy(owner, "apply", label)
    spy(attention_ops, "sinkhorn_scalings", "vector_qkv")
    spy(sinkhorn_ops, "sinkhorn_normalize", "vector_logits")
    return calls


@pytest.mark.parametrize("name", list(MODELS))
def test_robust_sites_keep_their_ops(name, sites):
    """The robust sites in call order; vanilla ones reach no Sinkhorn op and
    no kernel but the packed one and the fused LayerNorm, which serve both
    modes."""
    cls, kwargs, image, want = MODELS[name]
    torch.manual_seed(0)
    x = torch.randn(2, image, image, 3)
    cls(robust=False, device="cpu", **kwargs)(x)
    assert sites == [s for s in want if s[0] in BOTH_MODES]
    sites.clear()
    cls(robust=True, device="cpu", **kwargs)(x)
    assert sites == want


@pytest.mark.parametrize("robust", [False, True])
def test_vit_sites_take_the_four_iteration_schedule(robust, monkeypatch):
    """The VisionTransformer's packed calls run (4 iterations, no final row
    norm), the vendored-MHA schedule, where SimpleViT's run (3, final)."""
    schedules = []
    real = pa.PackedAttention.apply
    monkeypatch.setattr(pa.PackedAttention, "apply",
                        lambda qkv, *a: schedules.append(a[3:]) or real(qkv, *a))
    torch.manual_seed(0)
    x = torch.randn(2, 32, 32, 3)
    for name in ("vit", "simple_vit_d32"):
        cls, kwargs, _, _ = MODELS[name]
        cls(robust=robust, device="cpu", **kwargs)(x)
    assert schedules == [(robust, 4, False)] * 2 + [(robust, 3, True)] * 2
