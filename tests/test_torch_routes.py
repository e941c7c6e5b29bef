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
every norm whose width is inside its gate (a multiple of 32): the shared
blocks' norms of the SimpleViTs at D 64 and 128, the small Swins' norms at
32 and 64 (not stage 0's at 16) and the small CvTs' stage-3 channel norms
at 32 (not stages 1 and 2 at 16 and 24), and no norm of MobileViT's (16 and
24). The
torchvision-style VisionTransformer's sites take the packed kernels, both
modes, on its 4-iteration schedule with no final row norm.
"""

import functools
import math

import pytest
import torch

from noise_robust_vit_tpu_torch import (CaiT, CvT, LeViT, MobileViT, SimpleViT, SwinTransformer,
                                        VisionTransformer, create_model)
from noise_robust_vit_tpu_torch.models.vision_transformer import ConvStemConfig
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
S1 = (2, 4, 4, 32)  # the small Swins' stage-1 map, a fused LayerNorm's x
# name → (class, keyword arguments, image size, the sites in call order);
# the configs are those of tests/test_torch_{simple_vit,swin,levit,cait,cvt,
# mobile_vit,vision_transformer,fused_ln}.py
MODELS = {
    "simple_vit_d32": (SimpleViT, dict(image_size=32, patch_size=8, num_classes=10, dim=64,
                                       depth=2, heads=2, mlp_dim=128, dim_head=32), 32,
                       [("fused_ln", (2, 16, 64)), ("packed", (2, 16, 192)),
                        ("fused_ln", (2, 16, 64))] * 2),
    "simple_vit_d16": (SimpleViT, dict(image_size=32, patch_size=8, num_classes=10, dim=64,
                                       depth=2, heads=2, mlp_dim=128, dim_head=16), 32,
                       [("fused_ln", (2, 16, 64)), ("fused", (2, 2, 16, 16)),
                        ("fused_ln", (2, 16, 64))] * 2),
    "swin_v1": (SwinTransformer, dict(patch_size=(4, 4), embed_dim=16, depths=(2, 2),
                                      num_heads=(2, 2), window_size=(4, 4), num_classes=5,
                                      stochastic_depth_prob=0.0, version=1), 32,
                [("biased", (8, 2, 16, 8))] * 2 + [("fused_ln", (2, 4, 4, 64))]
                + [("fused_ln", S1), ("biased", (2, 2, 16, 16)), ("fused_ln", S1)] * 2
                + [("fused_ln", S1)]),
    "swin_v2": (SwinTransformer, dict(patch_size=(4, 4), embed_dim=16, depths=(2, 2),
                                      num_heads=(2, 2), window_size=(4, 4), num_classes=5,
                                      stochastic_depth_prob=0.0, version=2), 32,
                [("biased", (8, 2, 16, 8))] * 2 + [("fused_ln", S1)]
                + [("biased", (2, 2, 16, 16)), ("fused_ln", S1), ("fused_ln", S1)] * 2
                + [("fused_ln", S1)]),
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
               [("rect", (2, 1, 64, 16)), ("rect", (2, 1, 16, 4)), ("fused_ln", (2, 2, 2, 32)),
                ("fused_ln", (2, 2, 2, 32)), ("vector_logits", (2, 2, 4, 1)),
                ("fused_ln", (2, 2, 2, 32))]),
    "cvt_112": (CvT, dict(num_classes=5, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24,
                          s2_heads=1, s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1), 112,
                [("streaming", (2, 1, 784, 64)), ("rect", (2, 1, 196, 49)),
                 ("fused_ln", (2, 7, 7, 32)), ("fused_ln", (2, 7, 7, 32)),
                 ("rect", (2, 2, 49, 16)), ("fused_ln", (2, 7, 7, 32))]),
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


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# every launch counter, by the name the tables below use
COUNTERS = {"packed": pa.launches, "packed_resident": pa.launches_resident,
            "packed_scratch": pa.launches_scratch, "biased": ba.launches,
            "biased_resident": ba.launches_resident, "biased_shared": ba.launches_shared,
            "square": ss.launches, "rect": ss.launches_rect, "talking_heads": th.launches,
            "talking_heads_cluster": th.launches_cluster, "talking_heads_plane": th.launches_plane,
            "streaming": sa.launches, "streaming_split": sa.launches_split,
            "streaming_tile": sa.launches_tile, "fused": fa.launches,
            "fused_resident": fa.launches_resident, "fused_recompute": fa.launches_recompute,
            "fused_ln": fl.launches}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return {k: (c.fwd, c.bwd) for k, c in COUNTERS.items()}


def _reset():
    for c in COUNTERS.values():
        c.reset()


def _want(nonzero):
    """Every counter's (fwd, bwd): ``nonzero``'s count each way, 0 elsewhere."""
    return {k: (nonzero.get(k, 0),) * 2 for k in COUNTERS}


LEVIT_SMALL = dict(img_size=112, patch_size=16, num_classes=10, embed_dim=(32, 48, 64),
                   key_dim=(16, 16, 16), depth=(1, 1, 1), num_heads=(2, 3, 4),
                   attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
                   down_ops=(("Subsample", 16, 2, 4, 2, 2), ("Subsample", 16, 3, 4, 2, 2)))
CVT_SMALL = dict(num_classes=10, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24,
                 s2_heads=1, s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1)
MVIT_SMALL = dict(num_classes=10, dims=(16, 24, 16),
                  channels=(8, 8, 12, 16, 16, 24, 24, 24, 24, 32, 48), depths=(1, 1, 1))
CAIT_SMALL = dict(num_classes=10, image_size=56, patch_size=8, dim=64, depth=2, cls_depth=1,
                  mlp_dim=128)
VIT_SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=64,
                 mlp_dim=128, num_classes=10)


def _swin_small(version, window):
    return dict(patch_size=(4, 4), embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                window_size=(window, window), num_classes=10, stochastic_depth_prob=0.0,
                version=version)


# CaiT as ``create_model`` builds it, its weights drawn from the seed: with
# the class's own initialisation the CLS stage's head-mix gradients are
# ~1e-10, rounding alone, which no relative tolerance can compare
CAIT = functools.partial(create_model, "cait")
# name → (builder, keyword arguments, image size, train mode, seed of the
# parameters' perturbation (None: as built), gradient tolerance relative to
# each tensor's largest magnitude, the card's launches each way). Swin: a
# shifted and an unshifted block at N = 49 (v1) or 64 (v2), no window padded
# (a padded token's q is exactly zero, and v2's q / max(‖q‖, 1e-12)
# multiplies its gradient by 1e12); LeViT, CvT and MobileViT in train mode
# (BatchNorm's running statistics); CaiT's CLS stage gives its to_q and to_kv
# tiny gradients, hence the relative tolerance; float32 takes the scratch,
# shared-memory, plane, tile and recompute branches.
SMALL = {
    "swin_v1": (SwinTransformer, _swin_small(1, 7), 56, False, None, False,
                {"biased": 4, "biased_shared": 4, "fused_ln": 11}),
    "swin_v2": (SwinTransformer, _swin_small(2, 8), 64, False, None, False,
                {"biased": 4, "biased_shared": 4, "fused_ln": 11}),
    "levit": (LeViT, LEVIT_SMALL, 112, True, 21, False,
              {"biased": 3, "biased_shared": 3, "rect": 2}),
    "cait_4_heads": (CAIT, dict(CAIT_SMALL, heads=4), 56, False, None, True,
                     {"talking_heads": 2, "talking_heads_cluster": 2}),
    "cait_16_heads": (CAIT, dict(CAIT_SMALL, heads=16), 56, False, None, True,
                      {"talking_heads": 2, "talking_heads_plane": 2}),
    "cvt": (CvT, CVT_SMALL, 112, True, 41, False,
            {"streaming": 1, "streaming_tile": 1, "rect": 2, "fused_ln": 3}),
    "mobile_vit": (MobileViT, MVIT_SMALL, 128, True, 51, False,
                   {"fused": 3, "fused_recompute": 3}),
    "simple_vit_fused_ln": (SimpleViT, dict(num_classes=10, image_size=64, patch_size=8,
                                            dim=128, depth=2, heads=2, mlp_dim=256,
                                            dim_head=64), 64, False, 61, False,
                            {"fused_ln": 4, "packed": 2, "packed_scratch": 2}),
    "vit_patch_stem": (VisionTransformer, VIT_SMALL, 32, False, 64, False,
                       {"packed": 2, "packed_scratch": 2}),
    "vit_conv_stem": (VisionTransformer,
                      dict(VIT_SMALL, conv_stem_configs=[ConvStemConfig(16, 3, 2),
                                                         ConvStemConfig(24, 3, 2),
                                                         ConvStemConfig(32, 3, 2)]),
                      32, True, 64, False, {"packed": 2, "packed_scratch": 2}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SMALL))
def test_small_model_on_card_matches_cpu(cuda, name):
    """A small robust float32 model on the card (kernels) against the same
    weights on the CPU (plain versions), one forward and backward of 4
    images: logits and every buffer atol 1e-4 / rtol 1e-3, every gradient
    rtol 1e-3 and atol 1e-4 (of the tensor's largest magnitude where so
    marked); the card's launches by counter, none on the CPU."""
    cls, kwargs, image, train, perturb, relative, launches = SMALL[name]
    cpu = cls(robust=True, device="cpu", **kwargs)
    if perturb is not None:
        gen = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    card = cls(robust=True, device=cuda, **kwargs)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(4, image, image, 3, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        model.train(train)
        _reset()
        logits = model(x.to(dev))
        torch.nn.functional.cross_entropy(logits.float(), y.to(dev)).backward()
        torch.cuda.synchronize()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()}, _launches()))
    assert outs[0][3] == _want({})
    assert outs[1][3] == _want(launches)
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    for k, g in outs[0][1].items():
        atol = 1e-4 * (g.abs().max().item() if relative else 1.0)
        torch.testing.assert_close(outs[1][1][k], g, atol=atol, rtol=1e-3, msg=k)
    for k, b in outs[0][2].items():
        torch.testing.assert_close(outs[1][2][k], b, atol=1e-4, rtol=1e-3, msg=k)


# name → (image size, the robust step's launches each way, the vanilla
# step's, the packed calls' (iterations, final row norm)): every robust
# attention site on the branch the main path takes, and every norm inside
# the fused LayerNorm's gate on its kernels (SimpleViT-B/16's 24 block
# norms, Swin-T's and CvT-13's 29, MobileViT-XS's four at 96), both modes
FULL = {
    "simple_vit_b16": (224, {"packed": 12, "packed_resident": 12, "fused_ln": 24},
                       {"packed": 12, "packed_resident": 12, "fused_ln": 24}, (3, True)),
    "vit_b_16": (224, {"packed": 12, "packed_resident": 12},
                 {"packed": 12, "packed_resident": 12}, (4, False)),
    "swin_t": (224, {"biased": 12, "biased_resident": 12, "fused_ln": 29}, {"fused_ln": 29},
               None),
    "swin_v2_t": (224, {"biased": 12, "biased_resident": 12, "fused_ln": 29},
                  {"fused_ln": 29}, None),
    "levit": (224, {"biased": 9, "biased_resident": 7, "biased_shared": 2, "rect": 2}, {}, None),
    "LeViT_256": (224, {"biased": 12, "biased_resident": 8, "biased_shared": 4, "rect": 2}, {},
                  None),
    "cait": (224, {"talking_heads": 6, "talking_heads_cluster": 6}, {}, None),
    "cvt_13": (224, {"streaming": 3, "streaming_split": 3, "rect": 10, "fused_ln": 29},
               {"fused_ln": 29}, None),
    "mobile_vit_xs": (256, {"fused": 9, "fused_resident": 9, "fused_ln": 4}, {"fused_ln": 4},
                      None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("robust", [True, False], ids=["robust", "vanilla"])
@pytest.mark.parametrize("name", list(FULL))
def test_full_size_step_launches(cuda, name, robust, monkeypatch):
    """Five bf16 AdamW steps (lr 1e-4, wd 0.05) of the full-size model on
    one fixed batch of 64: finite, falling loss, and every step's launches
    by counter (the packed calls on the model's schedule)."""
    from noise_robust_vit_tpu_torch.train import create_train_state

    image, on_robust, on_vanilla, schedule = FULL[name]
    schedules = []
    real = pa.PackedAttention.apply
    monkeypatch.setattr(pa.PackedAttention, "apply",
                        lambda qkv, *a: schedules.append(a[3:]) or real(qkv, *a))
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(64, image, image, 3, generator=gen, device=cuda).to(torch.bfloat16)
    y = torch.randint(0, 1000, (64,), generator=gen, device=cuda)
    model = create_model(name, num_classes=1000, image_size=image, robust=robust,
                         dtype=torch.bfloat16, device=cuda, seed=0)
    state = create_train_state(model, lr=1e-4, weight_decay=0.05)
    losses, launches = [], []
    for _ in range(5):
        _reset()
        losses.append(float(state.train_step(x, y)))
        launches.append(_launches())
    want = _want(on_robust if robust else on_vanilla)
    assert all(step == want for step in launches), launches
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
    assert set(schedules) == ({(robust, *schedule)} if schedule else set())
