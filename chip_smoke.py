#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: builds the hand-written
kernels, holds them against their plain PyTorch versions, takes a few
SimpleViT-B/16 (its block norms on the fused LayerNorm kernels), vit_b_16,
Swin-T, LeViT-128S, CaiT and CvT-13 @224 and MobileViT-XS @256 bf16 train
steps through them, and times kernels and steps.

    python3 chip_smoke.py     # all phases; ~3 minutes on an H100

Phases, one line each (or a few):
  1. device   the card's name and power limit, as nvidia-smi reports them;
              exits non-zero without a CUDA device
  2. build    nvcc build of noise_robust_vit_tpu_torch/ops/cuda/csrc (one nvcc
              a source, in parallel), seconds; the resident packed and fused
              kernels' registers, stack and spills from the build's -Xptxas
              -v report
  3. kernels  the packed branch rule, Python's formula against the
              library's at every N ≤ 1024 and D 32/64/128; packed kernels
              against their plain versions at [8, 196|197, 2304] (H=12,
              D=64), vanilla and three Sinkhorn schedules, at
              SimpleViT-B/16's [256, 196, 2304], vanilla and robust (3,
              final), and at vit_b_16's [256, 197, 2304] bf16, vanilla and
              robust (4, no final row norm), bf16 there on the resident
              branch with the bits of two runs; the scratch branch in
              float32 at those shapes, in bf16 forced at [8, 196, 2304] and
              above the resident range at [8, 400, 2304], every mode;
              the biased branch rule, Python's formula against the library's
              at every N ≤ 80; biased kernels against theirs at the four
              Swin-T stage shapes of a batch of 128 with their real window
              counts, swin_v2_t's N=64, LeViT-128S's three stages [256, 4,
              196 | 6, 49 | 8, 16, 16] (DV 32), LeViT-256's stages 0 and 1
              [64, 4, 196 | 6, 49, 32] (DV 64; at N=196 o/a and t1 in
              32-column chunks) and Twins' local [8192, 8, 49, 64] with no
              bias, out, residual rows, dq, dk, dv and dbias, every mode:
              bf16 at N ≤ 64 on the resident branch with the bits of two
              runs, float32 and N=196 on the shared-memory branch, each
              call's branch by its launch counts, and the shared-memory
              branch forced in bf16 at Swin-T stage 0; the square and rectangular
              logits-interface Sinkhorn kernels against theirs at
              LeViT-128S's and LeViT-256's subsample logits, CvT-13 stage
              3's [128, 6, 196, 49], deepvit's
              [128, 8, 197, 197], 196×196 (nest_tiny's N), ragged shapes and
              matrices held in a global scratch slot, out, residual rows and
              d logits, three schedules. float32: atol 1e-4, rtol 1e-3 (the
              sums run in another order and the reverse chain amplifies
              it), dbias atol 1e-3 (a sum over up to 128 windows'
              gradients); bfloat16: atol 2e-2 (one bf16 rounding of values
              of order one), the Sinkhorn weights and d logits (of order
              1/N) rtol 8e-3 (one bf16 ulp) and atol 1e-3/N; the
              talking-heads kernels against theirs at CaiT's [128, 8, 196,
              196], ragged N (197, 21) and 16 heads, (3, final) and (4, no
              final), float32 and bfloat16, out, residual rows, d dots, d pre
              and d post (d pre and d post, sums over every image and entry,
              to 1e-4 of their largest magnitude in float32, 1e-3 in
              bfloat16), on both branches where the rule picks the cluster
              one (the plane one forced), 16 heads on the plane branch, each
              call's branch by its launch counts, and the bits of two runs
              at CaiT's shape on each branch; the
              streaming kernels of both branches against theirs at CvT-13's
              stage 1 [128, 1, 3136 | 784, 64], stage 2 [128, 3, 784 | 196,
              64] and Twins-SVT-S's stage-1 global [16, 8, 3136 | 64, 64]
              bf16 (the split branch by the rule, the tile branch forced),
              and a ragged float32 [2, 2, 300 | 130, 24] (tile), (3, final),
              (4, no final) and (1, final), out, residual vectors, dq, dk, dv,
              each call's branch by its launch counts, the bits of two runs
              at every bf16 check of the split branch and of the tile branch
              at stage 1 (3, final); the fused q/k/v branch
              rule, Python's formula against the library's at every N ≤ 300;
              the fused q/k/v kernels against theirs at MobileViT-XS's three
              stages [2048, 256 | 64 | 16, 8] (512 sequences × 4 heads of 8)
              bf16 (the resident branch) and float32, ragged N (50, 100), DV ≠
              D and D = 32 (the recompute branch), every mode, out, residual
              rows, dq, dk, dv, each call's branch by its launch counts, and
              the bits of two runs at each stage (bf16 vanilla and (3,
              final), float32 (3, final)); the fused
              LayerNorm kernels against theirs at SimpleViT-B/16's [50176,
              768] bf16 and float32, D 128, 1024, 1280 and 8192, ragged row
              counts (1, 500), y, dx, dscale and dbias (y and dx float32 atol
              and rtol 1e-5, bf16 one bf16 ulp, rtol 8e-3, atol 1e-2;
              dscale and dbias, sums over every row, to 1e-5 of their
              largest magnitude, rtol 1e-4), the bits of two runs, and no
              launch at D = 96 (outside the gate)
  4. slice    small SimpleViT, Swin v1/v2, LeViT and CaiT models, kernels against
              the plain path (LeViT in train mode, with its BN running
              statistics); 5 AdamW steps (lr 1e-4, wd 0.05) on one fixed
              batch of 64, robust and vanilla, of SimpleViT-B/16, Swin-T and
              LeViT-128S bf16: finite, falling loss, and the launches per
              step of each kernel (12 packed and 24 fused-LN, SimpleViT;
              12 biased robust, all resident, 0 vanilla, Swin-T; 9 biased (7 resident, 2
              shared-memory) and 2 rect robust, 0 vanilla, LeViT-128S); one
              robust fwd+bwd of swin_v2_t bf16 at batch 32 (N=64, 12
              resident) and of LeViT-256 bf16 at batch 64 (12 biased: 8
              resident, stage 0's 4 shared-memory at DV 64; 2 rect, 0
              square); robust_softmax fwd+bwd
              on deepvit's square f32 logits [128, 8, 197, 197] (1 square
              launch each way: no ported model runs the square kernel yet);
              small CaiTs f32 robust (N = 49) card vs cpu (2 talking-heads
              launches each way: at 4 heads all cluster, at 16 all plane);
              5 + 5 steps of CaiT @224 bf16 at batch 64 (6 talking-heads
              launches each way a robust step, all on the cluster branch, 0
              square and 0 rect; none vanilla); small CvT f32 robust at 112 px card vs
              cpu in train mode (stage 1 streams: 1 streaming launch each
              way, on the tile branch, and 2 rect); 5 + 5 steps of CvT-13
              @224 bf16 at batch 64 (3 streaming launches each way a robust
              step, all on the split branch, and 10 rect, 0 square, 0
              biased; none vanilla); small MobileViT f32 robust at
              128 px card vs cpu in train mode (3 fused launches each way, on
              the recompute branch); 5 + 5 steps of MobileViT-XS @256 bf16 at
              batch 64 (9 fused launches each way a robust step, all on the
              resident branch, no other kernel; none vanilla); every earlier
              model's steps count 0 fused launches;
              small robust f32 VisionTransformers card vs cpu, patch stem
              and conv stem in train mode (BN statistics), 2 packed launches
              each way; 5 + 5 steps of vit_b_16 (12 packed each way a step on
              (4, no final row norm), 0 fused-LN); every model's steps but
              SimpleViT-B/16's count 0 fused-LN launches; every
              SimpleViT-B/16 and vit_b_16 step's 12 + 12 packed launches
              are on the resident branch (0 scratch), and the small float32
              models launch the scratch branch
  5. timing   kernels against plain versions at [256, 196, 2304] (packed,
              and at vit_b_16's [256, 197, 2304] on (4, no final); both
              modes, the resident and the scratch branch in turns in the
              same call, and the resident ones must be faster; the scratch
              branch alone in float32 at [256, 196, 2304], robust),
              [8192, 3, 49, 32], nW=64 (biased: the resident and the
              shared-memory branch in turns, both modes, and the resident
              ones must be faster; scaled_dot_product_attention as the
              vanilla yardstick, without dbias and with the bias's
              gradient; the shared-memory kernels alone at LeViT-128S's and
              LeViT-256's stage 0), and
              [256, 8, 49, 196] and [128, 6, 196, 49] (rect) and [128, 8,
              197, 197] (square) f32 with torch.softmax as the vanilla
              counterpart, the talking-heads kernels at CaiT's [128, 8, 196,
              196] f32, the cluster and the plane branch in turns (the
              cluster ones must be faster), beside the vanilla sandwich
              (einsum, torch.softmax, einsum), and the
              streaming kernels at CvT-13's stages 1 and 2 bf16, the split
              and the tile branch in turns (the split ones must be faster),
              beside their plain versions, the vector form,
              scaled_dot_product_attention, the bound and the sweep floor;
              the fused kernels at MobileViT-XS's
              three stages bf16, robust and vanilla, the resident and the
              recompute branch in turns in the same call (at stage 1 the
              resident ones must be faster), beside their plain versions and
              (vanilla) scaled_dot_product_attention, at stage 1 the vector
              form, at stages 2 and 3 the biased kernels with no bias (the
              matrix held in shared memory), and the recompute branch alone
              in float32 at stage 1; the train step of SimpleViT-B/16
              at batch 256, Swin-T at batch 128, LeViT-128S at batch 256,
              CaiT, CvT-13 and MobileViT-XS (256 px) at batch 128 (median of
              3 windows of 5 steps after one warm-up step): img/s, the
              host's time to enqueue a step, MFU
              against 989 TFLOP/s dense bf16, peak memory, and CaiT's,
              CvT-13's and MobileViT-XS's robust/vanilla ratios; the fused
              LayerNorm kernels at [50176, 768] bf16 beside their plain
              versions, F.layer_norm (bf16 x, weight and bias;
              backward through autograd) and the port's eager
              LayerNorm module; vit_b_16 at batch 256 (MFU from 197 tokens)
  6. profile  device time by op and kernel over one robust train step of
              each model (torch.profiler), the top rows; vit_b_16 too
Every phase logs its wall seconds ("time:" lines). Then the card line
again, a {"kernels": [...]} JSON line, and as the last line {"ok": true,
"device": {...}}. Any failed check raises, and the script exits non-zero
without printing the last line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor cores,
# float32 outside them, device memory
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
MODES = [(False, 3, True), (True, 3, True), (True, 4, False), (True, 4, True)]
CSRC = "noise_robust_vit_tpu_torch/ops/cuda/csrc/"
PALLAS = "noise_robust_vit_tpu/ops/pallas/"
# Swin-T @224, batch 128: the biased calls' q/k/v shapes and window counts
# (tools/dispatch_audit.jsonl)
SWIN_T_STAGES = [((8192, 3, 49, 32), 64), ((2048, 6, 49, 32), 16),
                 ((512, 12, 49, 32), 4), ((128, 24, 49, 32), 1)]


def log(msg: str) -> None:
    print(msg, flush=True)


def vit_train_flops_per_image(image=224, patch=16, dim=768, depth=12, heads=12,
                              mlp=3072, classes=1000, cls_token=False):
    """bench.py's analytic train FLOPs per image (bwd ≈ 2× fwd), over the
    (image/patch)² patches and, with ``cls_token``, one token more in the
    blocks (vit_b_16's 197)."""
    patches = (image // patch) ** 2
    n = patches + int(cls_token)
    per_block = (
        2 * n * dim * (3 * dim)      # qkv proj
        + 2 * n * n * dim            # q@k^T
        + 2 * n * n * dim            # attn@v
        + 2 * n * dim * dim          # out proj
        + 2 * n * dim * mlp * 2      # mlp fc1+fc2
    )
    fwd = patches * 2 * (patch * patch * 3) * dim + depth * per_block + 2 * dim * classes
    return 3 * fwd


def swin_fwd_macs_per_image(image=224, patch=4, embed=96, depths=(2, 2, 6, 2),
                            window=7, mlp_ratio=4, classes=1000):
    """Analytic forward multiply-adds of one image through Swin (the unit of
    torchvision's published 4.49 "GFLOPS" for Swin-T): the patch
    convolution, per block qkv, q·kᵀ and attn·v over the padded windows,
    proj and the MLP, the patch mergings and the head."""
    h = image // patch
    macs = h * h * patch * patch * 3 * embed
    for i, depth in enumerate(depths):
        c = embed * 2 ** i
        tokens, padded = h * h, (math.ceil(h / window) * window) ** 2
        per_block = (padded * c * 3 * c + 2 * padded * window * window * c
                     + padded * c * c + 2 * tokens * c * mlp_ratio * c)
        macs += depth * per_block
        if i < len(depths) - 1:
            h = math.ceil(h / 2)
            macs += h * h * 4 * c * 2 * c
    return macs + embed * 2 ** (len(depths) - 1) * classes


def chain_passes(robust, iters, final_row):
    """N² passes of the Sinkhorn chain over each matrix: (forward, reverse,
    rank-1 terms of the reverse)."""
    if not robust:
        return 0, 0, 0
    return iters - 1 + final_row + iters, final_row + 2 * iters - 1, final_row + 2 * iters - 1


def bound_ms(nbytes, mma_flops, f32_ops):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rates (products on the
    bf16 tensor cores, the elementwise and reduction passes in float32)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = mma_flops / PEAK_BF16 + f32_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_work(items, n, d, dv, in_bytes, out_bytes, robust, iters, final_row,
                   bias_add, m=None):
    """(fwd, bwd) bounds of one attention call over `items` (image, head)
    matrices of n queries and m keys (m = n by default): the bytes each
    direction must move once, its products (fwd q·kᵀ and attn·v; bwd the
    q·kᵀ recompute, dV, dA, dQ, dK, and o/a when robust), each counted once
    whatever a kernel recomputes, and its float32 passes over the n·m
    entries (scale and bias, softmax, the chain, the softmax vjp, the rank-1
    terms)."""
    fp, bp, nt = chain_passes(robust, iters, final_row)
    nm = items * n * (n if m is None else m)
    fwd = bound_ms(in_bytes[0] + out_bytes[0], 2 * nm * (d + dv),
                   nm * (4 + bias_add + 2 * fp))
    bwd_products = 3 * d + (3 if robust else 2) * dv
    bwd = bound_ms(in_bytes[1] + out_bytes[1], 2 * nm * bwd_products,
                   nm * (3 + bias_add + 2 * bp + 4 + 2 * nt))
    return fwd, bwd


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def lap_clock():
    """``lap(name)`` logs the wall seconds since the previous lap (or since
    this call) and since this call: where the run's time goes."""
    start = last = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"time: {name} {now - last:.1f} s (run {now - start:.1f} s)")
        last = now
    return lap


def device_normal(torch, dev, rng, shape):
    """Standard normal float32 ``shape`` drawn on the card from a generator
    seeded by the numpy ``rng``: drawing the checks' hundreds of millions of
    inputs on the host took tens of seconds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2**62)))
    return torch.randn(shape, generator=gen, device=dev)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(pa, torch, dev):
    """Kernel against plain version. The branch rule: Python's formula
    against the library's (``nrv_packed_resident_fits``) at every N ≤ 1024
    and D in (32, 64, 128). Every mode at [8, 196|197, 2304], and the main
    paths' shapes at batch 256, where each persistent block takes many
    heads in turn: SimpleViT-B/16's [256, 196, 2304] vanilla and robust (3,
    final), vit_b_16's [256, 197, 2304] bf16 vanilla and robust (4, no final
    row norm); bf16 at N ≤ RESIDENT_MAX_N takes the resident branch, and at
    batch 256 each bf16 mode is also run twice for the same bits. The
    scratch branch: float32 (as above), bf16 forced onto it at [8, 196,
    2304], and bf16 above the resident range at [8, 400, 2304], every mode.
    Returns the largest errors (fwd out, bwd dqkv): the resident branch's at
    each main path's shape (bf16), keyed by its N, and under "scratch" the
    scratch branch's in float32, the path the small float32 models take."""
    from noise_robust_vit_tpu_torch.ops.cuda import build

    lib = build.load_library()
    wrong = [(n, d) for n in range(1, 1025) for d in (32, 64, 128)
             if bool(lib.nrv_packed_resident_fits(n, d)) != pa._resident_fits(n, d)]
    if wrong:
        raise RuntimeError(f"packed branch rule: Python and csrc disagree at (N, D) {wrong[:8]}")
    log(f"kernels: packed branch rule: Python and csrc agree at N 1..1024, D 32/64/128; "
        f"resident for bf16, D 64, N <= {pa.RESIDENT_MAX_N}")
    worst = {key: {"fwd": 0.0, "bwd": 0.0} for key in (196, 197, "scratch")}
    rng = np.random.default_rng(0)
    h, d = 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, N, dtypes, modes, forced branch)
    groups = [(8, 196, (f32, bf16), MODES, None), (8, 197, (f32,), MODES, None),
              (8, 196, (bf16,), MODES, "scratch"), (8, 400, (bf16,), MODES, None),
              (256, 196, (f32, bf16), MODES[:2], None),
              (256, 197, (bf16,), [MODES[0], MODES[2]], None)]
    for b, n, dtypes, modes, forced in groups:
        qkv32 = device_normal(torch, dev, rng, (b, n, 3 * h * d))
        g32 = device_normal(torch, dev, rng, (b, n, h * d))
        for dtype in dtypes:
            qkv, g = qkv32.to(dtype), g32.to(dtype)
            branch = forced or pa.packed_branch(n, d, dtype)
            for robust, iters, final_row in modes:
                args = (h, d, d ** -0.5, robust, iters, final_row)
                out_k, vecs_k = pa.packed_attention_fwd_cuda(qkv, *args, branch=branch)
                dq_k = pa.packed_attention_bwd_cuda(qkv, g, vecs_k, *args, branch=branch)
                torch.cuda.synchronize()
                out_p, vecs_p = pa.packed_attention_fwd_plain(qkv, *args)
                dq_p = pa.packed_attention_bwd_plain(qkv, g, vecs_p, *args)
                torch.cuda.synchronize()
                e_out = (out_k.float() - out_p.float()).abs().max().item()
                e_vec = (vecs_k - vecs_p).abs().max().item()
                e_dq = (dq_k.float() - dq_p.float()).abs().max().item()
                log(f"kernels: {str(dtype).split('.')[1]} [{b},{n},{3 * h * d}] {branch} "
                    f"robust={int(robust)} iters={iters} final_row={int(final_row)} "
                    f"max_abs_err out={e_out:.3g} vecs={e_vec:.3g} dqkv={e_dq:.3g}")
                if dtype == f32:
                    torch.testing.assert_close(out_k, out_p, atol=1e-4, rtol=1e-3)
                    torch.testing.assert_close(vecs_k, vecs_p, atol=1e-4, rtol=1e-3)
                    torch.testing.assert_close(dq_k, dq_p, atol=1e-4, rtol=1e-3)
                else:
                    torch.testing.assert_close(out_k.float(), out_p.float(), atol=2e-2, rtol=0)
                    torch.testing.assert_close(vecs_k, vecs_p, atol=1e-3, rtol=1e-3)
                    torch.testing.assert_close(dq_k.float(), dq_p.float(), atol=2e-2, rtol=2e-2)
                key = "scratch" if dtype == f32 else n if b == 256 else None
                if key is not None:
                    worst[key]["fwd"] = max(worst[key]["fwd"], e_out)
                    worst[key]["bwd"] = max(worst[key]["bwd"], e_dq)
                if b == 256 and dtype == bf16:
                    out_2, vecs_2 = pa.packed_attention_fwd_cuda(qkv, *args, branch=branch)
                    dq_2 = pa.packed_attention_bwd_cuda(qkv, g, vecs_2, *args, branch=branch)
                    if not (torch.equal(out_2, out_k) and torch.equal(vecs_2, vecs_k)
                            and torch.equal(dq_2, dq_k)):
                        raise RuntimeError(f"packed kernels [{b},{n}] {branch} "
                                           f"robust={int(robust)}: two runs differ")
                    log(f"kernels: [{b},{n},{3 * h * d}] {branch} robust={int(robust)} "
                        f"iters={iters} final_row={int(final_row)}: two runs give the same bits")
                    del out_2, vecs_2, dq_2
                del out_k, vecs_k, dq_k, out_p, vecs_p, dq_p
        del qkv32, g32, qkv, g
    torch.cuda.empty_cache()
    return worst


def biased_pairs(ba, torch, q, k, v, g, bias, args, branch=None):
    """(kernel, plain) results of the biased kernels on the same inputs: out,
    vecs, dq, dk, dv, dbias (None with no bias)."""
    out_k, vecs_k = ba.biased_attention_fwd_cuda(q, k, v, bias, *args, branch=branch)
    got = (out_k, vecs_k, *ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs_k, *args,
                                                          branch=branch))
    torch.cuda.synchronize()
    out_p, vecs_p = ba.biased_attention_fwd_plain(q, k, v, bias, *args)
    want = (out_p, vecs_p, *ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs_p, *args))
    torch.cuda.synchronize()
    return got, want


def phase_biased_kernels(ba, torch, dev):
    """Biased kernels against their plain versions. The branch rule first:
    Python's formula against the library's (nrv_biased_resident_fits) at
    every N ≤ 80, D and DV in 8, 16, 32, 40, 64, 128, vanilla and robust at
    1, 3, 8 and 9 iterations. Then every mode, float32 and bfloat16: at the
    four Swin-T stage shapes of a batch of 128 with their real window
    counts, swin_v2_t's N=64 (stages 0 and 3 at batch 32), LeViT-128S's
    stages at batch 256 ([256, 4, 196 | 6, 49 | 8, 16, 16], DV=32, one
    per-head bias), LeViT-256's stages 0 and 1 at batch 64 ([64, 4, 196 |
    6, 49, 32], DV=64; at N=196 the shared-memory backward forms o/a and t1
    32 columns at a time), and Twins' local [8192, 8, 49, 64] with no bias.
    bf16 at N ≤ 64 takes the resident kernels, the rest (float32, N=196)
    the shared-memory kernels, each call's branch checked by its launch
    counts. Then the shared-memory kernels forced in bf16 at Swin-T stage 0,
    every mode. Each bf16 check of either branch runs twice for the same
    bits (at LeViT's N=196 the shared-memory backward sums dbias from
    several chunks).
    Returns the largest bfloat16 errors (fwd out; bwd dq, dk, dv, dbias):
    under "resident" at the Swin-T stage shapes, under "shared" at
    LeViT-128S's stage 0 (N=196), the shared kernels' main path."""
    from noise_robust_vit_tpu_torch.ops.cuda import build

    lib = build.load_library()
    combos = [(n, d, dv, robust, iters) for n in range(1, 81)
              for d in (8, 16, 32, 40, 64, 128) for dv in (8, 16, 32, 40, 64, 128)
              for robust, iters in ((False, 3), (True, 1), (True, 3), (True, 8), (True, 9))]
    wrong = [c for c in combos
             if bool(lib.nrv_biased_resident_fits(c[0], c[1], c[2], int(c[3]), c[4]))
             != ba._resident_fits(*c)]
    if wrong:
        raise RuntimeError(f"biased branch rule: Python and csrc disagree at {wrong[:5]}")
    log(f"kernels: biased branch rule: Python and the library agree at {len(combos)} shapes; "
        f"resident at bf16, N <= {max(c[0] for c in combos if ba._resident_fits(*c))}, "
        f"D and DV in {sorted({c[1] for c in combos if ba._resident_fits(*c)})}")
    worst = {b: {"fwd": 0.0, "bwd": 0.0} for b in ("resident", "shared")}
    rng = np.random.default_rng(10)
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, (BW, H, N, D, DV), nW, no_bias, dtypes, forced branch)
    cases = [(f"swin_t stage {i}", (*shape, shape[-1]), nw, False, (f32, bf16), None)
             for i, (shape, nw) in enumerate(SWIN_T_STAGES)]
    cases += [("swin_t stage 0", (*SWIN_T_STAGES[0][0], 32), SWIN_T_STAGES[0][1], False, (bf16,),
               "shared"),
              ("swin_v2_t stage 0", (1568, 3, 64, 32, 32), 49, False, (f32, bf16), None),
              ("swin_v2_t stage 3", (32, 24, 64, 32, 32), 1, False, (f32, bf16), None),
              ("levit_128s stage 0", (256, 4, 196, 16, 32), 1, False, (f32, bf16), None),
              ("levit_128s stage 1", (256, 6, 49, 16, 32), 1, False, (f32, bf16), None),
              ("levit_128s stage 2", (256, 8, 16, 16, 32), 1, False, (f32, bf16), None),
              ("levit_256 stage 0", (64, 4, 196, 32, 64), 1, False, (f32, bf16), None),
              ("levit_256 stage 1", (64, 6, 49, 32, 64), 1, False, (f32, bf16), None),
              ("twins local", (8192, 8, 49, 64, 64), 1, True, (f32, bf16), None)]
    names = ["out", "vecs", "dq", "dk", "dv", "dbias"]
    branches = {"resident": ba.launches_resident, "shared": ba.launches_shared}
    for label, (bw, h, n, d, dv), nw, no_bias, dtypes, forced in cases:
        q32, k32 = (device_normal(torch, dev, rng, (bw, h, n, d)) for _ in range(2))
        v32, g32 = (device_normal(torch, dev, rng, (bw, h, n, dv)) for _ in range(2))
        bias = device_normal(torch, dev, rng, (nw, h, n, n))
        for dtype in dtypes:
            q, k, v, g = (t.to(dtype) for t in (q32, k32, v32, g32))
            for robust, iters, final_row in MODES:
                args = (d ** -0.5, robust, iters, final_row, nw, no_bias)
                branch = forced or ba.biased_branch(n, d, dv, dtype, robust, iters)
                for c in branches.values():
                    c.reset()
                got, want = biased_pairs(ba, torch, q, k, v, g, bias, args, forced)
                if any((c.fwd, c.bwd) != ((1, 1) if b == branch else (0, 0))
                       for b, c in branches.items()):
                    raise RuntimeError(f"biased {label} {dtype}: expected one {branch} launch "
                                       "each way and no other")
                errs = {nm: (a.float() - b.float()).abs().max().item()
                        for nm, a, b in zip(names, got, want) if a is not None}
                log(f"kernels: biased {label} {str(dtype).split('.')[1]} [{bw},{h},{n},{d}] "
                    f"DV={dv} nW={nw} no_bias={int(no_bias)} {branch} robust={int(robust)} "
                    f"iters={iters} final_row={int(final_row)} max_abs_err "
                    + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items()))
                for nm, a, b in zip(names, got, want):
                    if a is None:
                        if b is not None:
                            raise RuntimeError(f"{label}: kernel gave no {nm}")
                        continue
                    if dtype == f32:
                        atol = 1e-3 if nm == "dbias" else 1e-4
                        torch.testing.assert_close(a, b, atol=atol, rtol=1e-3, msg=nm)
                    elif nm == "vecs":
                        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3, msg=nm)
                    else:
                        rtol = 0 if nm == "out" else 2e-2
                        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                                   rtol=rtol, msg=nm)
                key = ("resident" if dtype == bf16 and label.startswith("swin_t") and not forced
                       else "shared" if dtype == bf16 and label == "levit_128s stage 0"
                       else None)
                if key:
                    worst[key]["fwd"] = max(worst[key]["fwd"], errs["out"])
                    worst[key]["bwd"] = max(worst[key]["bwd"],
                                            *(errs[nm] for nm in names[2:] if nm in errs))
                if dtype == bf16:
                    again = ba.biased_attention_fwd_cuda(q, k, v, bias, *args, branch=forced)
                    again = (*again, *ba.biased_attention_bwd_cuda(q, k, v, bias, g, again[1],
                                                                   *args, branch=forced))
                    if not all(torch.equal(a, b) for a, b in zip(got, again) if a is not None):
                        raise RuntimeError(f"biased {branch} {label}: two runs differ")
                    log(f"kernels: biased {label} {branch} robust={int(robust)} iters={iters} "
                        f"final_row={int(final_row)}: two runs give the same bits")
                    del again
                del got, want
        del q32, k32, v32, g32, bias, q, k, v, g
        torch.cuda.empty_cache()
    return worst


def phase_small_swin(ba, torch, dev):
    """The Swin wiring through the biased kernels: small robust float32 Swin
    v1 and v2 models on the card (kernels) against the same weights on the
    CPU (plain versions). Window 7 over a 56×56 image (v1) and 8 over 64×64
    (v2): a shifted and an unshifted block at N=49 or 64, D=16. No window is
    padded: a padded token's q is exactly zero, and v2's q / max(‖q‖, 1e-12)
    multiplies its gradient by 1e12, which no tolerance can compare."""
    from noise_robust_vit_tpu_torch import SwinTransformer

    rng = np.random.default_rng(11)
    y = torch.from_numpy(rng.integers(0, 10, size=2))
    for version, window in ((1, 7), (2, 8)):
        size = 8 * window
        x = torch.from_numpy(rng.standard_normal((2, size, size, 3), dtype=np.float32))
        kw = dict(patch_size=(4, 4), embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                  window_size=(window, window), num_classes=10, stochastic_depth_prob=0.0,
                  robust=True, version=version)
        cpu = SwinTransformer(device="cpu", **kw)
        gpu = SwinTransformer(device=dev, **kw)
        gpu.load_state_dict(cpu.state_dict())
        outs = []
        for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
            ba.launches.reset()
            logits = model(xx)
            torch.nn.functional.cross_entropy(logits.float(), yy).backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()},
                         (ba.launches.fwd, ba.launches.bwd)))
        if outs[0][2] != (0, 0) or outs[1][2] != (4, 4):
            raise RuntimeError(f"small swin v{version}: launches cpu {outs[0][2]}, "
                               f"card {outs[1][2]}, expected (0, 0) and (4, 4)")
        torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
        for k, g in outs[0][1].items():
            torch.testing.assert_close(outs[1][1][k], g, atol=1e-4, rtol=1e-3, msg=k)
        err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
        log(f"slice: small Swin v{version} f32 robust card vs cpu: logits and grads "
            f"agree (max grad err {err:.3g}), launches fwd/bwd 4/4")


def sdpa_ms(torch, q, k, v, mask, g):
    """The vanilla yardstick: one scaled_dot_product_attention call forward,
    and its backward (dq, dk, dv) through autograd."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask), 10)
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qq, kk, vv, attn_mask=mask)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True), 10)
    return fwd, bwd


def sdpa_backend(torch, q, k, v, mask):
    """The backend scaled_dot_product_attention picks for these operands
    (torch._fused_sdp_choice), by name, or "unknown" where this PyTorch does
    not say."""
    from torch.nn.attention import SDPBackend

    choice = getattr(torch, "_fused_sdp_choice", None)
    return "unknown" if choice is None else SDPBackend(choice(q, k, v, attn_mask=mask)).name


def sdpa_dbias_ms(torch, q, k, v, bias, g):
    """The same function as the vanilla biased kernels, dbias included: one
    scaled_dot_product_attention call whose attn_mask is the bias [nW, H, N,
    N] (bf16) expanded over the images from a leaf that requires grad, so
    that its backward also yields dbias summed over the images. The first
    backend (memory-efficient, cuDNN, math) that takes a mask gradient is
    timed; returns (backend, fwd ms, bwd ms)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bw, h, n, _ = q.shape
    nw = bias.shape[0]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias.to(q.dtype))]

    def mask():
        return leaves[3].unsqueeze(0).expand(bw // nw, nw, h, n, n).reshape(bw, h, n, n)

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend):
            try:
                out = sdpa(*leaves[:3], attn_mask=mask())
                torch.autograd.grad(out, leaves, g)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            fwd = cuda_ms(lambda: sdpa(*leaves[:3], attn_mask=mask()), 10)
            out = sdpa(*leaves[:3], attn_mask=mask())
            bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 10)
            return backend.name, fwd, bwd
    raise RuntimeError("no scaled_dot_product_attention backend takes the mask's gradient")


def biased_bounds(q, v, bias, vecs, robust, no_bias=False):
    """(fwd, bwd) bounds of a biased call from its inputs (attention_work):
    the bytes each direction must move once (q, k, v, the bias, out and the
    residual rows; q, k, v, g, the rows and the bias in, dq, dk, dv and
    dbias out), its products and its float32 passes."""
    bw, h, n, d = q.shape
    el = q.element_size()
    qk_b, v_b = 2 * q.numel() * el, v.numel() * el
    vec_b, bias_b = vecs.numel() * 4, 0 if no_bias else bias.numel() * 4
    return attention_work(bw * h, n, d, v.shape[-1], (qk_b + v_b + bias_b,
                                                      qk_b + 2 * v_b + vec_b + bias_b),
                          (v_b + vec_b, qk_b + v_b + bias_b), robust, 3, True,
                          0 if no_bias else 1)


def phase_biased_times(ba, torch, dev, shape=SWIN_T_STAGES[0]):
    """Biased kernels at Swin-T stage 0, bf16, robust (3, final) and vanilla:
    the resident and the shared-memory kernels in turns (resident, shared,
    shared, resident; the mean of each pair), and the resident ones must be
    faster in both modes and directions; beside them the plain versions,
    the bound from these inputs, and for vanilla SDPA with the bias as its
    attn_mask (materialized as [BW, H, N, N] bf16), without dbias (and the
    backend it picks) and with it (sdpa_dbias_ms), and the faster of the
    two forwards. Returns the times by robust, each with its
    "resident" and "shared" entries."""
    (bw, h, n, d), nw = shape
    rng = np.random.default_rng(13)
    q, k, v, g = (device_normal(torch, dev, rng, (bw, h, n, d)).to(torch.bfloat16)
                  for _ in range(4))
    bias = device_normal(torch, dev, rng, (nw, h, n, n))
    times = {}
    for robust in (True, False):
        args = (d ** -0.5, robust, 3, True, nw, False)
        _, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
        runs = {}
        for branch in ("resident", "shared", "shared", "resident"):
            runs.setdefault(branch, []).append((
                cuda_ms(lambda: ba.biased_attention_fwd_cuda(q, k, v, bias, *args,
                                                             branch=branch), 20),
                cuda_ms(lambda: ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args,
                                                             branch=branch), 20)))
        t = {"fwd_plain": cuda_ms(lambda: ba.biased_attention_fwd_plain(q, k, v, bias, *args), 5),
             "bwd_plain": cuda_ms(lambda: ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs,
                                                                        *args), 5),
             "fwd_lib": None, "bwd_lib": None}
        lib = ""
        if not robust:
            mask = bias.to(torch.bfloat16).unsqueeze(0).expand(bw // nw, nw, h, n, n).reshape(
                bw, h, n, n)
            t["fwd_lib"], t["bwd_lib"] = sdpa_ms(torch, q, k, v, mask, g)
            plain_backend = sdpa_backend(torch, q, k, v, mask)
            del mask
            backend, t["fwd_lib_dbias"], t["bwd_lib_dbias"] = sdpa_dbias_ms(torch, q, k, v,
                                                                            bias, g)
            lib = (f"; sdpa fwd {t['fwd_lib']:.4f} bwd {t['bwd_lib']:.4f} (no dbias, "
                   f"{plain_backend}), with dbias ({backend}) fwd {t['fwd_lib_dbias']:.4f} "
                   f"bwd {t['bwd_lib_dbias']:.4f}; sdpa's faster fwd "
                   f"{min(t['fwd_lib'], t['fwd_lib_dbias']):.4f}")
        (t["fwd_bound"], t["fwd_by"]), (t["bwd_bound"], t["bwd_by"]) = biased_bounds(
            q, v, bias, vecs, robust)
        for branch, pairs in runs.items():
            t[branch] = {"fwd": statistics.mean(p[0] for p in pairs),
                         "bwd": statistics.mean(p[1] for p in pairs)}
        new, old = t["resident"], t["shared"]
        times[robust] = t
        log(f"timing: biased attention bf16 [{bw},{h},{n},{d}] nW={nw} robust={int(robust)}"
            f"{' (3, final)' if robust else ''} ms: resident fwd {new['fwd']:.4f} "
            f"{[round(p[0], 4) for p in runs['resident']]} bwd {new['bwd']:.4f} "
            f"{[round(p[1], 4) for p in runs['resident']]}; shared fwd {old['fwd']:.4f} "
            f"{[round(p[0], 4) for p in runs['shared']]} bwd {old['bwd']:.4f} "
            f"{[round(p[1], 4) for p in runs['shared']]}; plain fwd {t['fwd_plain']:.4f} bwd "
            f"{t['bwd_plain']:.4f}; bound fwd {t['fwd_bound']:.4f} {t['fwd_by']} bwd "
            f"{t['bwd_bound']:.4f} {t['bwd_by']}{lib}; resident/shared fwd "
            f"{new['fwd'] / old['fwd']:.4f} bwd {new['bwd'] / old['bwd']:.4f}")
        if not (new["fwd"] < old["fwd"] and new["bwd"] < old["bwd"]):
            raise RuntimeError(f"biased robust={int(robust)}: the resident kernels are not "
                               "faster than the shared-memory kernels")
        del vecs
    # what BiasedAttention's contiguous copies of the q, k, v views that
    # Swin's qkv projection gives cost at this shape
    qkv = torch.cat([q, k, v], dim=-1).transpose(1, 2).reshape(bw, n, 3 * h * d)
    views = qkv.reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    copies = cuda_ms(lambda: [t.contiguous() for t in views], 20)
    log(f"timing: contiguous copies of q, k, v from the qkv projection [{bw},{n},{3 * h * d}] "
        f"bf16: {copies:.4f} ms")
    del q, k, v, g, bias, qkv, views
    torch.cuda.empty_cache()
    return times


def phase_biased_levit_times(ba, torch, dev):
    """The shared-memory biased kernels at their main paths' shapes, bf16,
    robust (3, final), beside their plain versions and the bound: LeViT-128S
    stage 0 [256, 4, 196, 16] with DV=32 (2 launches each way a robust
    step) and LeViT-256 stage 0 [64, 4, 196, 32] with DV=64 (4; the
    backward forms o/a and t1 32 columns at a time). Returns LeViT-128S's
    times."""
    rng = np.random.default_rng(14)
    result = None
    for label, (bw, h, n, d, dv) in (("LeViT-128S", (256, 4, 196, 16, 32)),
                                     ("LeViT-256", (64, 4, 196, 32, 64))):
        q, k = (device_normal(torch, dev, rng, (bw, h, n, d)).to(torch.bfloat16)
                for _ in range(2))
        v, g = (device_normal(torch, dev, rng, (bw, h, n, dv)).to(torch.bfloat16)
                for _ in range(2))
        bias = device_normal(torch, dev, rng, (1, h, n, n))
        args = (d ** -0.5, True, 3, True, 1, False)
        _, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
        t = {"fwd": cuda_ms(lambda: ba.biased_attention_fwd_cuda(q, k, v, bias, *args), 20),
             "fwd_plain": cuda_ms(lambda: ba.biased_attention_fwd_plain(q, k, v, bias, *args), 5),
             "bwd": cuda_ms(lambda: ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args),
                            20),
             "bwd_plain": cuda_ms(lambda: ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs,
                                                                        *args), 5),
             "fwd_lib": None, "bwd_lib": None}
        (t["fwd_bound"], t["fwd_by"]), (t["bwd_bound"], t["bwd_by"]) = biased_bounds(
            q, v, bias, vecs, True)
        log(f"timing: biased attention bf16 {label} stage 0 [{bw},{h},{n},{d}] DV={dv} "
            f"shared robust=1 (3, final) ms: fwd {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, "
            f"bound {t['fwd_bound']:.4f} {t['fwd_by']}) bwd {t['bwd']:.4f} (plain "
            f"{t['bwd_plain']:.4f}, bound {t['bwd_bound']:.4f} {t['bwd_by']})")
        result = result or t
        del q, k, v, g, bias, vecs
    torch.cuda.empty_cache()
    return result


def phase_train(counts, torch, dev, name, per_step, steps=5, batch=64, image=224):
    """`steps` AdamW steps (lr 1e-4, wd 0.05) of `name` bf16 at full width on
    one fixed batch of `image`-pixel images, robust then vanilla: finite,
    falling loss, and `per_step[robust][k]` launches per step of each kernel
    that `counts[k]` counts. Returns the launches of both runs together, by
    counter."""
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    start = time.perf_counter()
    rng = np.random.default_rng(2)
    x = device_normal(torch, dev, rng, (batch, image, image, 3)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    total = {k: {"fwd": 0, "bwd": 0} for k in counts}
    for robust in (True, False):
        model = create_model(name, num_classes=1000, image_size=image, robust=robust,
                             dtype=torch.bfloat16, device=dev, seed=0)
        state = create_train_state(model, lr=1e-4, weight_decay=0.05)
        losses, launches = [], []
        for _ in range(steps):
            for c in counts.values():
                c.reset()
            losses.append(float(state.train_step(x, y)))
            launches.append({k: (c.fwd, c.bwd) for k, c in counts.items()})
        log(f"slice: {name} bf16 robust={int(robust)} batch={batch} "
            f"losses={[round(v, 5) for v in losses]} launches (fwd, bwd) per step="
            + ", ".join(f"{k} {[step[k] for step in launches]}" for k in counts))
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not fall: {losses}")
        for k in counts:
            want = per_step[robust][k]
            if any(step[k] != (want, want) for step in launches):
                raise RuntimeError(f"expected {want} launches of each {k} kernel per step, "
                                   f"got {[step[k] for step in launches]}")
            total[k]["fwd"] += sum(step[k][0] for step in launches)
            total[k]["bwd"] += sum(step[k][1] for step in launches)
        del model, state
    torch.cuda.empty_cache()
    log(f"time: train phase of {name} {time.perf_counter() - start:.1f} s")
    return total


def phase_swin_v2(ba, torch, dev, batch=32):
    """One robust fwd+bwd of swin_v2_t bf16, whose 12 attentions run the
    resident biased kernels at N=64."""
    from noise_robust_vit_tpu_torch import create_model

    rng = np.random.default_rng(12)
    x = device_normal(torch, dev, rng, (batch, 224, 224, 3)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    model = create_model("swin_v2_t", num_classes=1000, robust=True,
                         dtype=torch.bfloat16, device=dev, seed=0)
    ba.launches.reset()
    ba.launches_resident.reset()
    loss = torch.nn.functional.cross_entropy(model(x).float(), y)
    loss.backward()
    torch.cuda.synchronize()
    got = (ba.launches.fwd, ba.launches.bwd, ba.launches_resident.fwd, ba.launches_resident.bwd)
    log(f"slice: swin_v2_t bf16 robust batch={batch} fwd+bwd loss={float(loss):.5f} "
        f"biased launches fwd={got[0]} bwd={got[1]}, resident {got[2]}/{got[3]} (N=64)")
    if not math.isfinite(float(loss)) or got != (12, 12, 12, 12):
        raise RuntimeError("swin_v2_t: non-finite loss or not 12 resident launches of each "
                           "kernel")
    del model
    torch.cuda.empty_cache()


# The logits-interface kernels' checked shapes: LeViT-128S's subsample
# logits at batch 256, LeViT-256's at batch 64, CvT-13 stage 3's at batch
# 128 (6 heads, 196 queries, 49 keys), deepvit's square logits at batch 128
# (tools/dispatch_audit.jsonl), 196×196 at 3 and 4 heads
# (nest_tiny's N), ragged ones (rows not a multiple of 4, nr > nc), and
# matrices held in a global scratch slot (N above ~220)
SQUARE_PATH = (128, 8, 197, 197)
CVT_S3_RECT = (128, 6, 196, 49)
SINKHORN_SHAPES = [("levit_128s sub0", (256, 8, 49, 196)), ("levit_128s sub1", (256, 16, 16, 49)),
                   ("levit_256 sub0", (64, 8, 49, 196)), ("levit_256 sub1", (64, 12, 16, 49)),
                   ("cvt_13 stage 3", CVT_S3_RECT),
                   ("deepvit", SQUARE_PATH), ("square 196", (64, 4, 196, 196)),
                   ("square 196", (64, 3, 196, 196)),
                   ("ragged", (8, 3, 45, 45)), ("ragged", (8, 3, 33, 7)),
                   ("scratch", (4, 2, 640, 640)), ("scratch", (8, 300, 96))]
SINKHORN_MAIN = {"square": ("deepvit",), "rect": ("levit_128s", "cvt_13")}


def sinkhorn_pairs(ss, torch, logits, g, iters, final_row):
    """(kernel, plain) results of the square or rectangular kernels on the
    same inputs: out, the residual rows, d logits."""
    if logits.shape[-1] == logits.shape[-2]:
        out_k, vecs_k = ss.sinkhorn_softmax_fwd_cuda(logits, iters, final_row)
        got = (out_k, vecs_k, ss.sinkhorn_softmax_bwd_cuda(logits, g, vecs_k, iters, final_row))
        torch.cuda.synchronize()
        out_p, vecs_p = ss.sinkhorn_softmax_fwd_plain(logits, iters, final_row)
        want = (out_p, vecs_p, ss.sinkhorn_softmax_bwd_plain(logits, g, vecs_p, iters, final_row))
        return ["out", "vecs", "ds"], got, want
    out_k, va_k, vb_k = ss.sinkhorn_softmax_rect_fwd_cuda(logits, iters, final_row)
    got = (out_k, va_k, vb_k, ss.sinkhorn_softmax_rect_bwd_cuda(logits, g, va_k, vb_k, iters,
                                                                final_row))
    torch.cuda.synchronize()
    out_p, va_p, vb_p = ss.sinkhorn_softmax_rect_fwd_plain(logits, iters, final_row)
    want = (out_p, va_p, vb_p, ss.sinkhorn_softmax_rect_bwd_plain(logits, g, va_p, vb_p, iters,
                                                                   final_row))
    return ["out", "va", "vb", "ds"], got, want


def phase_sinkhorn_kernels(ss, torch, dev):
    """Square and rectangular logits-interface kernels against their plain
    versions at SINKHORN_SHAPES, the three Sinkhorn schedules of MODES (the
    kernels have no vanilla mode: plain softmax stays torch.softmax),
    float32 and bfloat16: out, residual rows and d logits. float32: atol
    1e-4, rtol 1e-3 (the sums run in another order and the reverse chain
    amplifies it); bfloat16: the weights and d logits, of order 1/N for N
    columns, to one bf16 ulp (rtol 8e-3) and atol 1e-3/N, the float32
    residual rows atol and rtol 1e-3. Returns the largest float32 errors (the main path's dtype)
    at the main path's shapes, by kernel and direction."""
    worst = {(kind, d): 0.0 for kind in ("square", "rect") for d in ("fwd", "bwd")}
    rng = np.random.default_rng(20)
    f32, bf16 = torch.float32, torch.bfloat16
    modes = [m[1:] for m in MODES if m[0]]
    for label, shape in SINKHORN_SHAPES:
        kind = "square" if shape[-1] == shape[-2] else "rect"
        s32 = 2 * device_normal(torch, dev, rng, shape)
        g32 = device_normal(torch, dev, rng, shape)
        for dtype in (f32, bf16):
            logits, g = s32.to(dtype), g32.to(dtype)
            for iters, final_row in modes:
                names, got, want = sinkhorn_pairs(ss, torch, logits, g, iters, final_row)
                torch.cuda.synchronize()
                errs = {nm: (a.float() - b.float()).abs().max().item()
                        for nm, a, b in zip(names, got, want)}
                log(f"kernels: sinkhorn_softmax {kind} {label} {str(dtype).split('.')[1]} "
                    f"{list(shape)} iters={iters} final_row={int(final_row)} max_abs_err "
                    + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items()))
                for nm, a, b in zip(names, got, want):
                    if dtype == f32:
                        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=nm)
                    elif nm in ("out", "ds"):
                        torch.testing.assert_close(a.float(), b.float(),
                                                   atol=1e-3 / shape[-1], rtol=8e-3, msg=nm)
                    else:
                        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3, msg=nm)
                if dtype == f32 and label.startswith(SINKHORN_MAIN[kind]):
                    worst[kind, "fwd"] = max(worst[kind, "fwd"], errs["out"])
                    worst[kind, "bwd"] = max(worst[kind, "bwd"], errs["ds"])
                del got, want
        del s32, g32, logits, g
        torch.cuda.empty_cache()
    return worst


LEVIT_SMALL = dict(img_size=112, patch_size=16, num_classes=10, embed_dim=(32, 48, 64),
                   key_dim=(16, 16, 16), depth=(1, 1, 1), num_heads=(2, 3, 4),
                   attn_ratio=(2, 2, 2), mlp_ratio=(2, 2, 2),
                   down_ops=(("Subsample", 16, 2, 4, 2, 2), ("Subsample", 16, 3, 4, 2, 2)))


def phase_small_levit(ba, ss, torch, dev):
    """The LeViT wiring through the kernels: a small robust float32 LeViT
    (image 112, embed (32, 48, 64), key dim 16, heads (2, 3, 4), depth 1 a
    stage) on the card against the same weights on the CPU, in train mode:
    logits, every parameter gradient and the BN running statistics after the
    step. Every parameter is perturbed from a seed, so that no branch is
    zero (the init's zero BN scales). 3 biased and 2 rectangular launches of
    each direction on the card, none on the CPU. The attention-bias tables'
    gradients are scattered back by index_put with atomics on the card, so
    they repeat only to rounding; the tolerance covers it."""
    from noise_robust_vit_tpu_torch import LeViT

    gen = torch.Generator().manual_seed(21)
    cpu = LeViT(robust=True, device="cpu", **LEVIT_SMALL)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    gpu = LeViT(robust=True, device=dev, **LEVIT_SMALL)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((4, 112, 112, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    outs = []
    for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        model.train()
        ba.launches.reset()
        ss.launches_rect.reset()
        logits = model(xx)
        torch.nn.functional.cross_entropy(logits.float(), yy).backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers() if k.endswith(("mean", "var"))},
                     (ba.launches.fwd, ba.launches.bwd, ss.launches_rect.fwd,
                      ss.launches_rect.bwd)))
    if outs[0][3] != (0, 0, 0, 0) or outs[1][3] != (3, 3, 2, 2):
        raise RuntimeError(f"small levit: launches (biased fwd, bwd, rect fwd, bwd) cpu "
                           f"{outs[0][3]}, card {outs[1][3]}, expected 0s and (3, 3, 2, 2)")
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    for i in (1, 2):
        for k, v in outs[0][i].items():
            torch.testing.assert_close(outs[1][i][k], v, atol=1e-4, rtol=1e-3, msg=k)
    err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
    err_bn = max((outs[1][2][k] - v).abs().max().item() for k, v in outs[0][2].items())
    log(f"slice: small LeViT f32 robust train mode card vs cpu: logits, grads and BN "
        f"running stats agree (max grad err {err:.3g}, stats {err_bn:.3g}), launches "
        f"biased 3/3, rect 2/2 on the card, 0 on the cpu")


def phase_levit_256(ba, ss, torch, dev, batch=64):
    """One robust fwd+bwd of LeViT-256 bf16: all twelve square attentions
    run the biased kernels, as in the JAX package, stages 1 and 2 (N=49 and
    16, 8 of them) the resident ones and stage 0's four at N=196 with DV=64
    the shared-memory ones; the two subsamples run the rectangular kernels;
    no square logits reach the square kernel."""
    from noise_robust_vit_tpu_torch import create_model

    rng = np.random.default_rng(23)
    x = device_normal(torch, dev, rng, (batch, 224, 224, 3)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    model = create_model("LeViT_256", num_classes=1000, robust=True, dtype=torch.bfloat16,
                         device=dev, seed=0)
    counts = {"square": ss.launches, "biased": ba.launches, "rect": ss.launches_rect,
              "biased_resident": ba.launches_resident, "biased_shared": ba.launches_shared}
    for c in counts.values():
        c.reset()
    loss = torch.nn.functional.cross_entropy(model(x).float(), y)
    loss.backward()
    loss = loss.item()
    got = {k: (c.fwd, c.bwd) for k, c in counts.items()}
    log(f"slice: LeViT_256 bf16 robust batch={batch} fwd+bwd loss={loss:.5f} "
        f"launches (fwd, bwd) {got}")
    want = {"square": (0, 0), "biased": (12, 12), "rect": (2, 2), "biased_resident": (8, 8),
            "biased_shared": (4, 4)}
    if not math.isfinite(loss) or got != want:
        raise RuntimeError(f"LeViT_256: non-finite loss or launches {got}, expected {want}")
    del model
    torch.cuda.empty_cache()


def phase_square_path(ss, torch, dev, shape=SQUARE_PATH):
    """The square kernels' path: ``ops.robust_softmax`` forward and backward
    on deepvit's float32 square logits (tools/dispatch_audit.jsonl), the
    call that deepvit, rvt, nest and cct make and that Swin's robust
    fallback makes; no ported model reaches it yet. One launch of each
    kernel, finite weights whose rows sum to one (the final row norm), and
    the gradient's shape. Returns the launches."""
    from noise_robust_vit_tpu_torch import ops

    rng = np.random.default_rng(25)
    logits = 2 * device_normal(torch, dev, rng, shape)
    g = device_normal(torch, dev, rng, shape)
    logits.requires_grad_(True)
    ss.launches.reset()
    out = ops.robust_softmax(logits, robust=True)
    out.backward(g)
    torch.cuda.synchronize()
    got = (ss.launches.fwd, ss.launches.bwd)
    rows = out.detach().sum(-1)
    err = (rows - 1).abs().max().item()
    log(f"slice: robust_softmax f32 {list(shape)} fwd+bwd: square launches (fwd, bwd) "
        f"{got}, max |row sum - 1| {err:.3g}")
    if got != (1, 1) or not torch.isfinite(out).all() or err > 1e-4 \
            or logits.grad is None or logits.grad.shape != logits.shape \
            or not torch.isfinite(logits.grad).all():
        raise RuntimeError(f"square path: launches {got}, row sum error {err}")
    del logits, g, out
    torch.cuda.empty_cache()
    return {"fwd": got[0], "bwd": got[1]}


def phase_sinkhorn_times(ss, torch, dev):
    """Square and rectangular kernels in float32 (the dtype the models pass)
    at [256, 8, 49, 196] (LeViT-128S subsample 0), [128, 6, 196, 49]
    (CvT-13 stage 3) and [128, 8, 197, 197] (deepvit), robust (3, final),
    beside their plain versions and
    torch.softmax forward and backward on the same logits (the vanilla
    model's cost for the same step, not a library yardstick: no PyTorch
    call computes softmax + Sinkhorn, so library_ms is null). Each bound
    comes from these inputs: the bytes each direction must move once, and
    its float32 passes over the matrix."""
    rng = np.random.default_rng(24)
    times = {}
    fp, bp, nt = chain_passes(True, 3, True)
    for key, shape in (("rect", (256, 8, 49, 196)), ("rect cvt_13", CVT_S3_RECT),
                       ("square", SQUARE_PATH)):
        kind = key.split()[0]
        logits = 2 * device_normal(torch, dev, rng, shape)
        g = device_normal(torch, dev, rng, shape)
        if kind == "square":
            fwd_k = lambda: ss.sinkhorn_softmax_fwd_cuda(logits)  # noqa: E731
            fwd_p = lambda: ss.sinkhorn_softmax_fwd_plain(logits)  # noqa: E731
            res = fwd_k()[1:]
            bwd_k = lambda: ss.sinkhorn_softmax_bwd_cuda(logits, g, *res)  # noqa: E731
            bwd_p = lambda: ss.sinkhorn_softmax_bwd_plain(logits, g, *res)  # noqa: E731
        else:
            fwd_k = lambda: ss.sinkhorn_softmax_rect_fwd_cuda(logits)  # noqa: E731
            fwd_p = lambda: ss.sinkhorn_softmax_rect_fwd_plain(logits)  # noqa: E731
            res = fwd_k()[1:]
            bwd_k = lambda: ss.sinkhorn_softmax_rect_bwd_cuda(logits, g, *res)  # noqa: E731
            bwd_p = lambda: ss.sinkhorn_softmax_rect_bwd_plain(logits, g, *res)  # noqa: E731
        t = {"fwd": cuda_ms(fwd_k, 20), "fwd_plain": cuda_ms(fwd_p, 5),
             "bwd": cuda_ms(bwd_k, 20), "bwd_plain": cuda_ms(bwd_p, 5),
             "fwd_lib": None, "bwd_lib": None}
        sm_fwd = cuda_ms(lambda: torch.softmax(logits, -1), 20)
        xs = logits.detach().requires_grad_(True)
        out = torch.softmax(xs, -1)
        sm_bwd = cuda_ms(lambda: torch.autograd.grad(out, xs, g, retain_graph=True), 20)
        mat, vec = logits.numel() * 4, sum(r.numel() for r in res) * 4
        nn = logits.numel()
        t["fwd_bound"], t["fwd_by"] = bound_ms(2 * mat + vec, 0, nn * (4 + 2 * fp))
        t["bwd_bound"], t["bwd_by"] = bound_ms(3 * mat + vec, 0, nn * (3 + 2 * bp + 4 + 2 * nt))
        times[key] = t
        log(f"timing: sinkhorn_softmax {key} f32 {list(shape)} (3, final) ms: fwd "
            f"{t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} "
            f"{t['fwd_by']}) bwd {t['bwd']:.4f} (plain {t['bwd_plain']:.4f}, bound "
            f"{t['bwd_bound']:.4f} {t['bwd_by']}); vanilla counterpart torch.softmax fwd "
            f"{sm_fwd:.4f} bwd {sm_bwd:.4f}")
        del logits, g, res, xs, out
    torch.cuda.empty_cache()
    return times


def phase_kernel_times(pa, torch, dev, b=256, n=196, h=12, d=64, iters=3, final_row=True,
                       dtype=None, robusts=(True, False)):
    """Packed kernels at [b, n, 3·h·d] (bf16 unless `dtype`) on the robust
    schedule (iters, final_row) and vanilla: where the shape takes the
    resident branch, it and the scratch branch in turns (resident, scratch,
    scratch, resident; the mean of each pair), else the scratch branch
    twice, beside the plain versions and, vanilla, SDPA. Returns
    times[robust][branch] with the plain, library and bound entries under
    every branch."""
    dtype = dtype or torch.bfloat16
    rng = np.random.default_rng(3)
    qkv = device_normal(torch, dev, rng, (b, n, 3 * h * d)).to(dtype)
    g = device_normal(torch, dev, rng, (b, n, h * d)).to(dtype)
    both = pa.packed_branch(n, d, dtype) == "resident"
    times = {}
    for robust in robusts:
        args = (h, d, d ** -0.5, robust, iters, final_row)
        _, vecs = pa.packed_attention_fwd_cuda(qkv, *args)
        runs = {}
        for branch in ("resident", "scratch", "scratch", "resident") if both else ("scratch",) * 2:
            runs.setdefault(branch, []).append((
                cuda_ms(lambda: pa.packed_attention_fwd_cuda(qkv, *args, branch=branch), 10),
                cuda_ms(lambda: pa.packed_attention_bwd_cuda(qkv, g, vecs, *args,
                                                             branch=branch), 10)))
        common = {
            "fwd_plain": cuda_ms(lambda: pa.packed_attention_fwd_plain(qkv, *args), 5),
            "bwd_plain": cuda_ms(lambda: pa.packed_attention_bwd_plain(qkv, g, vecs, *args), 5),
            "fwd_lib": None, "bwd_lib": None,
        }
        if not robust:
            q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
            common["fwd_lib"], common["bwd_lib"] = sdpa_ms(
                torch, q, k, v, None, g.reshape(b, n, h, d).transpose(1, 2).contiguous())
            del q, k, v
        qkv_b, out_b = qkv.numel() * qkv.element_size(), g.numel() * g.element_size()
        vec_b = vecs.numel() * 4
        (common["fwd_bound"], common["fwd_by"]), (common["bwd_bound"], common["bwd_by"]) = \
            attention_work(b * h, n, d, d, (qkv_b, qkv_b + out_b + vec_b),
                           (out_b + vec_b, qkv_b), robust, iters, final_row, 0)
        times[robust] = {}
        for branch, pairs in runs.items():
            t = dict(common, fwd=statistics.mean(p[0] for p in pairs),
                     bwd=statistics.mean(p[1] for p in pairs))
            times[robust][branch] = t
            lib = "" if robust else f"; sdpa fwd {t['fwd_lib']:.4f} bwd {t['bwd_lib']:.4f}"
            sched = f"({iters}, {'final' if final_row else 'no final'})" if robust else "vanilla"
            log(f"timing: packed attention {str(dtype).split('.')[1]} [{b},{n},{3 * h * d}] {branch} "
                f"robust={int(robust)} {sched} ms: fwd {t['fwd']:.4f} "
                f"{[round(p[0], 4) for p in pairs]} (plain {t['fwd_plain']:.4f}, bound "
                f"{t['fwd_bound']:.4f} {t['fwd_by']}) bwd {t['bwd']:.4f} "
                f"{[round(p[1], 4) for p in pairs]} (plain {t['bwd_plain']:.4f}, bound "
                f"{t['bwd_bound']:.4f} {t['bwd_by']}){lib}")
        if not both:
            continue
        new, old = times[robust]["resident"], times[robust]["scratch"]
        log(f"timing: packed [{b},{n}] robust={int(robust)} resident/scratch time ratio "
            f"fwd {new['fwd'] / old['fwd']:.4f} bwd {new['bwd'] / old['bwd']:.4f}")
        if not (new["fwd"] < old["fwd"] and new["bwd"] < old["bwd"]):
            raise RuntimeError(f"packed [{b},{n}] robust={int(robust)}: the resident kernels "
                               "are not faster than the scratch kernels")
    del qkv, g
    torch.cuda.empty_cache()
    return times


def phase_step_times(torch, dev, name, batch, flops, steps=5, windows=3, image=224):
    """Train step of `name` (bf16, 1000 classes, AdamW lr 1e-3) at `batch` of
    `image`-pixel images, vanilla then robust: median img/s of `windows`
    windows of `steps` steps, the host's time to enqueue a step (until the
    window's last train_step returns, before the synchronising read of the
    loss), MFU from the analytic `flops` per image, and peak device
    memory."""
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    start = time.perf_counter()
    rng = np.random.default_rng(4)
    x = device_normal(torch, dev, rng, (batch, image, image, 3)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    result = {}
    for robust in (False, True):
        model = create_model(name, num_classes=1000, image_size=image, robust=robust,
                             dtype=torch.bfloat16, device=dev, seed=0)
        state = create_train_state(model, lr=1e-3, weight_decay=0.05)
        torch.cuda.reset_peak_memory_stats(dev)
        float(state.train_step(x, y))  # warm-up
        rates, enqueue = [], []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = state.train_step(x, y)
            enqueue.append((time.perf_counter() - t0) / steps)
            loss = float(loss)
            rates.append(batch * steps / (time.perf_counter() - t0))
        rate = statistics.median(rates)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        result[robust] = rate
        log(f"timing: train step {name} bf16 batch={batch} robust={int(robust)}: "
            f"{rate:.2f} img/s (windows {[round(r, 2) for r in rates]}), "
            f"{1e3 * batch / rate:.2f} ms/step, host enqueue "
            f"{1e3 * statistics.median(enqueue):.2f} ms/step, MFU {rate * flops / PEAK_BF16:.4f}, "
            f"peak mem {peak:.2f} GiB, loss {loss:.4f}")
        del model, state
    torch.cuda.empty_cache()
    log(f"time: step times of {name} {time.perf_counter() - start:.1f} s")
    return result


def phase_profile(torch, dev, name, batch, rows=25, image=224):
    """Device time by op and kernel over one robust train step."""
    from torch.profiler import ProfilerActivity, profile

    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    x = device_normal(torch, dev, rng, (batch, image, image, 3)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    model = create_model(name, num_classes=1000, image_size=image, robust=True,
                         dtype=torch.bfloat16, device=dev, seed=0)
    state = create_train_state(model)
    for _ in range(2):
        state.train_step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state.train_step(x, y)
        torch.cuda.synchronize()
    log(f"profile: {name} robust train step, batch {batch}, top rows by device time")
    events = prof.key_averages()
    log(events.table(sort_by="cuda_time_total", row_limit=rows))
    # the hand-written kernels (namespace nrv), which the table may rank
    # below its last row
    for evt in events:
        if "nrv::" in evt.key:
            log(f"profile: {name} kernel {evt.key[:90]}: {evt.count} launches, "
                f"{evt.device_time_total / 1e3:.3f} ms of device time")
    del model, state
    torch.cuda.empty_cache()
    log(f"time: profile of {name} {time.perf_counter() - t0:.1f} s")


# The talking-heads kernels' checked shapes: CaiT @224 at batch 128
# (tools/dispatch_audit.jsonl), ragged N (197, 21), 16 heads; (label,
# shape, dtypes). Where the rule sends a shape to the cluster branch, both
# branches are checked there (the plane one forced); 16 heads stay on the
# plane branch.
CAIT_TH = (128, 8, 196, 196)
TH_SHAPES = [("cait", CAIT_TH, ("float32",)), ("cait", (16, 8, 196, 196), ("bfloat16",)),
             ("ragged", (16, 8, 197, 197), ("float32", "bfloat16")),
             ("ragged", (4, 4, 21, 21), ("float32", "bfloat16")),
             ("16 heads", (8, 16, 196, 196), ("float32",))]
TH_SCHEDULES = ((3, True), (4, False))


def th_inputs(torch, dev, rng, shape, dtype=None):
    """dots (2·N(0, 1)), g, pre and post (N(0, 1)) on the card."""
    h = shape[1]
    dots, g = (scale * device_normal(torch, dev, rng, shape) for scale in (2.0, 1.0))
    pre, post = (device_normal(torch, dev, rng, (h, h)) for _ in range(2))
    if dtype is not None:
        dots, g = dots.to(dtype), g.to(dtype)
    return dots, g, pre, post


def th_pairs(th, torch, dots, g, pre, post, iters, final_row, branch):
    """(kernel, plain) results of the talking-heads kernels of ``branch`` on
    the same inputs: out, vecs, d dots, d pre, d post (the plain d pre and
    d post summed as the branch's kernels sum them)."""
    out_k, vecs_k = th.talking_heads_fwd_cuda(dots, pre, post, iters, final_row, branch=branch)
    got = (out_k, vecs_k, *th.talking_heads_bwd_cuda(dots, g, vecs_k, pre, post, iters, final_row,
                                                     branch=branch))
    torch.cuda.synchronize()
    strips = dots.shape[1] if branch == "cluster" else None
    out_p, vecs_p = th.talking_heads_fwd_plain(dots, pre, post, iters, final_row)
    want = (out_p, vecs_p, *th.talking_heads_bwd_plain(dots, g, vecs_p, pre, post, iters,
                                                       final_row, strips=strips))
    torch.cuda.synchronize()
    return got, want


def phase_th_kernels(th, torch, dev):
    """Talking-heads kernels against their plain versions at TH_SHAPES, both
    schedules, (3, final) and (4, no final), on the branch the rule picks
    and, where that is the cluster branch, on the plane branch forced too;
    each call's branch shown by its launch counts. float32: out, vecs and
    d dots atol 1e-4, rtol 1e-3 (the sums run in another order and the
    reverse chain amplifies it); d pre and d post, each entry a sum over
    every image and n² entries (4.9 M products at CaiT's shape), to 1e-4 of
    the tensor's largest magnitude. bfloat16 dots (math in float32): out and
    d dots atol 2e-2 (one bf16 rounding of values of order one), vecs 1e-3,
    d pre and d post 1e-3 of their largest magnitude. Then two runs at
    CaiT's shape give the same bits on each branch. Returns the largest
    float32 absolute errors at CaiT's shape, (3, final), by branch: fwd
    (out), bwd (d dots, d pre, d post)."""
    worst = {br: {"fwd": 0.0, "bwd": 0.0} for br in th.BRANCHES}
    rng = np.random.default_rng(30)
    names = ["out", "vecs", "ddots", "dpre", "dpost"]
    by_branch = {"cluster": th.launches_cluster, "plane": th.launches_plane}
    for label, shape, dtypes in TH_SHAPES:
        for dname in dtypes:
            dtype = getattr(torch, dname)
            bf16 = dtype == torch.bfloat16
            dots, g, pre, post = th_inputs(torch, dev, rng, shape, dtype)
            rule = th.talking_heads_branch(shape, 3, dtype)
            branches = ("cluster", "plane") if rule == "cluster" else ("plane",)
            for branch in branches:
                for iters, final_row in TH_SCHEDULES:
                    for counts in by_branch.values():
                        counts.reset()
                    got, want = th_pairs(th, torch, dots, g, pre, post, iters, final_row, branch)
                    ran = {br: (c.fwd, c.bwd) for br, c in by_branch.items()}
                    if ran[branch] != (1, 1) or sum(map(sum, ran.values())) != 2:
                        raise RuntimeError(f"talking heads {label} {branch}: launches {ran}")
                    errs = {nm: (a.float() - b.float()).abs().max().item()
                            for nm, a, b in zip(names, got, want)}
                    rel = {nm: errs[nm] / want[i].abs().max().item()
                           for i, nm in enumerate(names) if i >= 3}
                    log(f"kernels: talking_heads {label} {dname} {list(shape)} {branch} "
                        f"(rule: {rule}) iters={iters} final_row={int(final_row)} max_abs_err "
                        + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items())
                        + " | of the largest "
                        + " ".join(f"{nm}={e:.3g}" for nm, e in rel.items()))
                    for i, (nm, a, b) in enumerate(zip(names, got, want)):
                        if i >= 3:
                            if rel[nm] > (1e-3 if bf16 else 1e-4):
                                raise RuntimeError(f"talking heads {branch} {nm}: {rel[nm]:.3g} "
                                                   f"of the largest magnitude")
                        elif nm == "vecs":
                            torch.testing.assert_close(a, b, atol=1e-3 if bf16 else 1e-4,
                                                       rtol=1e-3, msg=nm)
                        elif bf16:
                            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=0,
                                                       msg=nm)
                        else:
                            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=nm)
                    if shape == CAIT_TH and not bf16 and (iters, final_row) == (3, True):
                        worst[branch]["fwd"] = errs["out"]
                        worst[branch]["bwd"] = max(errs["ddots"], errs["dpre"], errs["dpost"])
                        again = th_pairs(th, torch, dots, g, pre, post, iters, final_row,
                                         branch)[0]
                        if not all(torch.equal(a, b) for a, b in zip(got, again)):
                            raise RuntimeError(f"talking heads {branch}: two runs gave "
                                               f"different bits")
                        log(f"kernels: talking_heads {list(shape)} float32 {branch}: two runs "
                            f"give the same bits (out, vecs, d dots, d pre, d post)")
                        del again
                    del got, want
            del dots, g, pre, post
            torch.cuda.empty_cache()
    return worst


def phase_small_cait(th, torch, dev):
    """The CaiT wiring through the talking-heads kernels: small robust
    float32 CaiTs (image 56, patch 8: N = 49, ragged rows; dim 64, depth 2,
    cls_depth 1) on the card against the same weights on the CPU: logits
    (atol 1e-4, rtol 1e-3) and every parameter gradient (rtol 1e-3, atol
    1e-4 of each tensor's largest magnitude: the CLS stage's one query row
    gives its to_q and to_kv tiny gradients). 4 heads run the cluster
    kernels, 16 heads the plane kernels: 2 launches each way on the card on
    that branch, none on the other, none on the CPU. Returns the plane
    branch's launches (the 16-head model's)."""
    from noise_robust_vit_tpu_torch import create_model

    plane = {}
    for heads, branch in ((4, "cluster"), (16, "plane")):
        kw = dict(num_classes=10, image_size=56, patch_size=8, robust=True, dim=64, depth=2,
                  cls_depth=1, heads=heads, mlp_dim=128)
        cpu = create_model("cait", device="cpu", **kw)
        gpu = create_model("cait", device=dev, **kw)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(31)
        x = torch.from_numpy(rng.standard_normal((4, 56, 56, 3), dtype=np.float32))
        y = torch.from_numpy(rng.integers(0, 10, size=4))
        outs = []
        for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
            for counts in (th.launches, th.launches_cluster, th.launches_plane):
                counts.reset()
            logits = model(xx)
            torch.nn.functional.cross_entropy(logits.float(), yy).backward()
            mine = th.launches_cluster if branch == "cluster" else th.launches_plane
            outs.append((logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()},
                         (th.launches.fwd, th.launches.bwd), (mine.fwd, mine.bwd)))
        if outs[0][2] != (0, 0) or outs[1][2] != (2, 2) or outs[1][3] != (2, 2):
            raise RuntimeError(f"small cait ({heads} heads): launches cpu {outs[0][2]}, card "
                               f"{outs[1][2]} ({branch} {outs[1][3]}), expected (0, 0) and "
                               f"(2, 2) all {branch}")
        torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
        err = 0.0
        for k, g in outs[0][1].items():
            scale = g.abs().max().item()
            torch.testing.assert_close(outs[1][1][k], g, atol=1e-4 * scale, rtol=1e-3, msg=k)
            err = max(err, (outs[1][1][k] - g).abs().max().item() / max(scale, 1e-30))
        log(f"slice: small CaiT f32 robust, {heads} heads, card vs cpu: logits and grads agree "
            f"(max grad err {err:.3g} of the tensor's largest magnitude), talking-heads "
            f"launches 2/2 on the card, all {branch}, 0 on the cpu")
        if branch == "plane":
            plane = {"fwd": outs[1][3][0], "bwd": outs[1][3][1]}
    return plane


def phase_th_times(th, torch, dev, shape=CAIT_TH):
    """Talking-heads kernels at CaiT's float32 dots, robust (3, final): the
    cluster and plane branches in turns (plane, cluster, cluster, plane;
    the mean of each branch's two turns), beside their plain versions and
    the vanilla sandwich on the same inputs (einsum, torch.softmax, einsum;
    its backward to dots and both mixes through autograd): the vanilla
    model's cost for the same step, not a library yardstick, since no
    PyTorch call computes the sandwich with Sinkhorn (library_ms is null).
    Bounds from these inputs: the bytes each direction must move once, and
    the float32 work of the TPU kernel's own estimate,
    B·H·N²·(4 + 4·iters + 4·H) forward and B·H·N²·(8 + 4·iters + 8·H)
    backward. Returns each branch's times and the shared numbers."""
    h = shape[1]
    rng = np.random.default_rng(32)
    dots, g, pre, post = th_inputs(torch, dev, rng, shape)
    _, vecs = th.talking_heads_fwd_cuda(dots, pre, post)
    turns = {br: {"fwd": [], "bwd": []} for br in th.BRANCHES}
    for br in ("plane", "cluster", "cluster", "plane"):
        turns[br]["fwd"].append(cuda_ms(
            lambda: th.talking_heads_fwd_cuda(dots, pre, post, branch=br), 20))
        turns[br]["bwd"].append(cuda_ms(
            lambda: th.talking_heads_bwd_cuda(dots, g, vecs, pre, post, branch=br), 20))
    shared = {"fwd_plain": cuda_ms(lambda: th.talking_heads_fwd_plain(dots, pre, post), 5),
              "bwd_plain": cuda_ms(lambda: th.talking_heads_bwd_plain(dots, g, vecs, pre, post), 5),
              "fwd_lib": None, "bwd_lib": None}

    def sandwich(d, p, q):
        return torch.einsum("bhij,hg->bgij",
                            torch.softmax(torch.einsum("bhij,hg->bgij", d, p), -1), q)

    van_fwd = cuda_ms(lambda: sandwich(dots, pre, post), 20)
    leaves = [x.detach().requires_grad_(True) for x in (dots, pre, post)]
    out = sandwich(*leaves)
    van_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 20)
    mat, vec, mix = dots.numel() * 4, vecs.numel() * 4, 2 * h * h * 4
    nn = dots.numel()
    shared["fwd_bound"], shared["fwd_by"] = bound_ms(2 * mat + vec + mix, 0,
                                                     nn * (4 + 4 * 3 + 4 * h))
    shared["bwd_bound"], shared["bwd_by"] = bound_ms(3 * mat + vec + 2 * mix, 0,
                                                     nn * (8 + 4 * 3 + 8 * h))
    times = {}
    for br in th.BRANCHES:
        times[br] = dict(shared, fwd=sum(turns[br]["fwd"]) / 2, bwd=sum(turns[br]["bwd"]) / 2)
        log(f"timing: talking_heads {br} f32 {list(shape)} (3, final) ms: fwd "
            f"{times[br]['fwd']:.4f} (turns " + " ".join(f"{x:.4f}" for x in turns[br]["fwd"])
            + f") bwd {times[br]['bwd']:.4f} (turns "
            + " ".join(f"{x:.4f}" for x in turns[br]["bwd"]) + ")")
    log(f"timing: talking_heads f32 {list(shape)} (3, final): plain fwd "
        f"{shared['fwd_plain']:.4f} bwd {shared['bwd_plain']:.4f}; bound fwd "
        f"{shared['fwd_bound']:.4f} {shared['fwd_by']} bwd {shared['bwd_bound']:.4f} "
        f"{shared['bwd_by']}; vanilla sandwich (einsum, softmax, einsum) fwd {van_fwd:.4f} "
        f"bwd {van_bwd:.4f}; cluster/plane fwd "
        f"{times['cluster']['fwd'] / times['plane']['fwd']:.4f} bwd "
        f"{times['cluster']['bwd'] / times['plane']['bwd']:.4f}")
    for d in ("fwd", "bwd"):
        if not times["cluster"][d] < times["plane"][d]:
            raise RuntimeError(f"talking heads {d}: the cluster kernels ({times['cluster'][d]:.4f}"
                               f" ms) are not faster than the plane kernels "
                               f"({times['plane'][d]:.4f} ms)")
    del dots, g, pre, post, vecs, leaves, out
    torch.cuda.empty_cache()
    return times


# The streaming kernels' checked shapes: CvT-13 @224 at batch 128, stage 1
# and stage 2 (tools/dispatch_audit.jsonl), Twins-SVT-S's stage-1 global
# attention at batch 16 (8 heads, 3136 queries against 64 subsampled keys),
# and a ragged float32 shape that the TPU kernel pads on both sides; (label,
# (B, H, N, M, D), dtype). The bf16 D = 64 shapes are checked on both
# branches (split by the rule, tile forced), the float32 one on the tile
# branch, which alone takes it.
CVT_S1 = (128, 1, 3136, 784, 64)
CVT_S2 = (128, 3, 784, 196, 64)
TWINS_S1 = (16, 8, 3136, 64, 64)
STREAM_SHAPES = [("cvt stage 1", CVT_S1, "bfloat16"), ("cvt stage 2", CVT_S2, "bfloat16"),
                 ("twins-svt-s stage 1", TWINS_S1, "bfloat16"),
                 ("ragged", (2, 2, 300, 130, 24), "float32")]
STREAM_MODES = [(3, True), (4, False), (1, True)]
STREAM_BRANCHES = ("split", "tile")


def stream_inputs(torch, dev, rng, shape, dtype):
    """q, k, v and the upstream gradient, N(0, 1), on the card."""
    b, h, n, m, d = shape
    q, g = (device_normal(torch, dev, rng, (b, h, n, d)).to(dtype) for _ in range(2))
    k, v = (device_normal(torch, dev, rng, (b, h, m, d)).to(dtype) for _ in range(2))
    return q, k, v, g


def stream_kernels(sa, torch, q, k, v, g, iters, final_row, branch):
    """The streaming kernels of ``branch`` on these inputs: out, av, bv,
    dq, dk, dv."""
    scale = q.shape[-1] ** -0.5
    got = sa.streaming_attention_fwd_cuda(q, k, v, scale, iters, final_row, branch=branch)
    got = (*got, *sa.streaming_attention_bwd_cuda(q, k, v, g, *got[1:], scale, iters, final_row,
                                                  branch=branch))
    torch.cuda.synchronize()
    return got


def stream_plain(sa, torch, q, k, v, g, iters, final_row):
    """The plain versions' out, av, bv, dq, dk, dv."""
    scale = q.shape[-1] ** -0.5
    want = sa.streaming_attention_fwd_plain(q, k, v, scale, iters, final_row)
    want = (*want, *sa.streaming_attention_bwd_plain(q, k, v, g, *want[1:], scale, iters,
                                                     final_row))
    torch.cuda.synchronize()
    return want


def phase_stream_kernels(sa, torch, dev):
    """Streaming kernels of both branches against their plain versions at
    STREAM_SHAPES, (3, final), (4, no final) and (1, final): out, the
    residual vectors (lse and a, b), dq, dk and dv. float32: atol 1e-4,
    rtol 1e-3 (the sums run in another order and the reverse chain
    amplifies it); bfloat16 q, k, v (math in float32): out atol 2e-2 (one
    bf16 rounding of values of order one), dq, dk, dv atol and rtol 2e-2,
    the float32 residual vectors atol and rtol 1e-3. Every bf16 check of
    the split branch runs twice and must give the same bits; so does the
    tile branch at CvT stage 1, (3, final). Each call's branch is checked
    by its launch counts. Returns the largest errors of each branch at
    CvT's stages 1 and 2, (3, final): fwd (out), bwd (dq, dk, dv)."""
    worst = {b: {"fwd": 0.0, "bwd": 0.0} for b in STREAM_BRANCHES}
    rng = np.random.default_rng(40)
    names = ["out", "av", "bv", "dq", "dk", "dv"]
    for label, shape, dname in STREAM_SHAPES:
        dtype = getattr(torch, dname)
        bf16 = dtype == torch.bfloat16
        b, h, n, m, d = shape
        rule = sa.streaming_branch(n, m, d, dtype)
        branches = STREAM_BRANCHES if rule == "split" else ("tile",)
        q, k, v, g = stream_inputs(torch, dev, rng, shape, dtype)
        for iters, final_row in STREAM_MODES:
            want = stream_plain(sa, torch, q, k, v, g, iters, final_row)
            for branch in branches:
                counter = sa.launches_split if branch == "split" else sa.launches_tile
                counter.reset()
                got = stream_kernels(sa, torch, q, k, v, g, iters, final_row, branch)
                if (counter.fwd, counter.bwd) != (1, 1):
                    raise RuntimeError(f"streaming {branch}: launches {counter.fwd}/"
                                       f"{counter.bwd}, expected 1/1")
                errs = {nm: (a.float() - c.float()).abs().max().item()
                        for nm, a, c in zip(names, got, want)}
                log(f"kernels: streaming {branch} {label} {dname} {list(shape)} iters={iters} "
                    f"final_row={int(final_row)} max_abs_err "
                    + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items()))
                for nm, a, c in zip(names, got, want):
                    if nm in ("av", "bv"):
                        torch.testing.assert_close(a, c, atol=1e-3 if bf16 else 1e-4, rtol=1e-3,
                                                   msg=nm)
                    elif bf16:
                        torch.testing.assert_close(a.float(), c.float(), atol=2e-2,
                                                   rtol=0 if nm == "out" else 2e-2, msg=nm)
                    else:
                        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-3, msg=nm)
                main = label.startswith("cvt") and (iters, final_row) == (3, True)
                if main:
                    w = worst[branch]
                    w["fwd"] = max(w["fwd"], errs["out"])
                    w["bwd"] = max(w["bwd"], errs["dq"], errs["dk"], errs["dv"])
                if (branch == "split" and bf16) or (main and shape == CVT_S1):
                    again = stream_kernels(sa, torch, q, k, v, g, iters, final_row, branch)
                    if not all(torch.equal(a, c) for a, c in zip(got, again)):
                        raise RuntimeError(f"streaming {branch} {label}: two runs gave "
                                           f"different bits")
                    log(f"kernels: streaming {branch} {label} iters={iters} "
                        f"final_row={int(final_row)}: two runs give the same bits (out, av, "
                        f"bv, dq, dk, dv)")
                    del again
                del got
            del want
        del q, k, v, g
        torch.cuda.empty_cache()
    return worst


CVT_SMALL = dict(num_classes=10, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=24,
                 s2_heads=1, s2_depth=1, s3_emb_dim=32, s3_heads=2, s3_depth=1)


def phase_small_cvt(sa, ss, torch, dev):
    """The CvT wiring through the kernels: a small robust float32 CvT (dims
    16/24/32, heads 1/1/2 of 64, depth 1 a stage) at 112 px, where stage 1
    (784 queries × 196 keys) streams and stages 2 and 3 take the rect
    kernels ([4, 1, 196, 49], [4, 2, 49, 16]), on the card against the same
    weights on the CPU, in train mode: logits, every parameter gradient and
    the BN running statistics after the step (atol 1e-4, rtol 1e-3, as
    LeViT's). Every parameter is perturbed from a seed. 1 streaming (on the
    tile branch, which takes float32) and 2 rect launches each way on the
    card, none on the CPU. Returns the tile branch's launches."""
    from noise_robust_vit_tpu_torch import CvT

    gen = torch.Generator().manual_seed(41)
    cpu = CvT(robust=True, device="cpu", **CVT_SMALL)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    gpu = CvT(robust=True, device=dev, **CVT_SMALL)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((4, 112, 112, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    outs = []
    for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        model.train()
        for c in (sa.launches, sa.launches_tile, ss.launches_rect):
            c.reset()
        logits = model(xx)
        torch.nn.functional.cross_entropy(logits.float(), yy).backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()},
                     (sa.launches.fwd, sa.launches.bwd, ss.launches_rect.fwd,
                      ss.launches_rect.bwd, sa.launches_tile.fwd, sa.launches_tile.bwd)))
    if outs[0][3] != (0,) * 6 or outs[1][3] != (1, 1, 2, 2, 1, 1):
        raise RuntimeError(f"small cvt: launches (streaming fwd, bwd, rect fwd, bwd, streaming "
                           f"tile fwd, bwd) cpu {outs[0][3]}, card {outs[1][3]}, expected 0s "
                           f"and (1, 1, 2, 2, 1, 1)")
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    for i in (1, 2):
        for k, v in outs[0][i].items():
            torch.testing.assert_close(outs[1][i][k], v, atol=1e-4, rtol=1e-3, msg=k)
    err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
    err_bn = max((outs[1][2][k] - v).abs().max().item() for k, v in outs[0][2].items())
    log(f"slice: small CvT f32 robust 112 px train mode card vs cpu: logits, grads and BN "
        f"running stats agree (max grad err {err:.3g}, stats {err_bn:.3g}), launches "
        f"streaming 1/1 (tile branch: float32), rect 2/2 on the card, 0 on the cpu")
    return {"fwd": outs[1][3][4], "bwd": outs[1][3][5]}


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def stream_sweep_floor(items, n, m, d, sweeps, clock_mhz):
    """The least time of `sweeps` passes that each recompute q·kᵀ (at the
    dense bf16 peak) and one exponential an entry (16 a clock on each of
    132 SMs' special-function units), ms."""
    entries = items * n * m
    return sweeps * (2 * entries * d / PEAK_BF16 + entries / (16 * 132 * clock_mhz * 1e6)) * 1e3


def phase_stream_times(sa, torch, dev):
    """Streaming kernels of both branches at CvT-13's stage-1 and stage-2
    q/k/v (batch 128, bf16), robust (3, final), in turns (split, tile,
    tile, split; each branch's time the mean of its two turns), beside the
    plain versions, the vector form (float32 logits → ops.sinkhorn_attention
    → attn·v, its backward through autograd) and scaled_dot_product_attention
    (vanilla softmax, backward through autograd: the library yardstick).
    Each bound comes from these inputs: the bytes each direction must move
    once, q·kᵀ and attn·v counted once (attention_work with n queries and m
    keys); the sweep floor beside it counts every sweep's q·kᵀ and
    exponentials (iters + 1 sweeps forward, iters + 2 backward). Returns
    {label: {branch: times}}."""
    from noise_robust_vit_tpu_torch import ops

    rng = np.random.default_rng(43)
    clock = sm_clock_mhz()
    times = {}
    for label, shape in (("stage 1", CVT_S1), ("stage 2", CVT_S2)):
        b, h, n, m, d = shape
        q, k, v, g = stream_inputs(torch, dev, rng, shape, torch.bfloat16)
        scale = d ** -0.5
        _, av, bv = sa.streaming_attention_fwd_cuda(q, k, v, scale)
        turns = {br: {"fwd": [], "bwd": []} for br in STREAM_BRANCHES}
        for br in ("split", "tile", "tile", "split"):
            turns[br]["fwd"].append(cuda_ms(
                lambda: sa.streaming_attention_fwd_cuda(q, k, v, scale, branch=br), 10))
            turns[br]["bwd"].append(cuda_ms(
                lambda: sa.streaming_attention_bwd_cuda(q, k, v, g, av, bv, scale, branch=br),
                10))
        common = {"fwd_plain": cuda_ms(lambda: sa.streaming_attention_fwd_plain(q, k, v, scale),
                                       3),
                  "bwd_plain": cuda_ms(
                      lambda: sa.streaming_attention_bwd_plain(q, k, v, g, av, bv, scale), 3)}

        def vector(qq, kk, vv):
            logits = torch.matmul(qq.float(), kk.float().transpose(-1, -2)) * scale
            return torch.matmul(ops.sinkhorn_attention(logits).to(vv.dtype), vv)

        vec_fwd = cuda_ms(lambda: vector(q, k, v), 3)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = vector(*leaves)
        vec_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 3)
        del out, leaves
        torch.cuda.empty_cache()
        common["fwd_lib"], common["bwd_lib"] = sdpa_ms(torch, q, k, v, None, g)
        qkv_b, out_b = (q.numel() + k.numel() + v.numel()) * 2, q.numel() * 2
        vec_b = (av.numel() + bv.numel()) * 4
        (common["fwd_bound"], common["fwd_by"]), (common["bwd_bound"], common["bwd_by"]) = \
            attention_work(b * h, n, d, d, (qkv_b, qkv_b + out_b + vec_b),
                           (out_b + vec_b, qkv_b), True, 3, True, 0, m=m)
        floor = {dn: stream_sweep_floor(b * h, n, m, d, sweeps, clock)
                 for dn, sweeps in (("fwd", 4), ("bwd", 5))}
        times[label] = {br: dict(common, fwd=sum(t["fwd"]) / 2, bwd=sum(t["bwd"]) / 2)
                        for br, t in turns.items()}
        sp, ti = times[label]["split"], times[label]["tile"]
        log(f"timing: streaming attention bf16 CvT {label} {list(shape)} (3, final) ms: "
            f"split fwd {sp['fwd']:.4f} bwd {sp['bwd']:.4f} (turns fwd "
            f"{turns['split']['fwd']}, bwd {turns['split']['bwd']}); tile fwd {ti['fwd']:.4f} "
            f"bwd {ti['bwd']:.4f} (turns fwd {turns['tile']['fwd']}, bwd "
            f"{turns['tile']['bwd']}); split/tile fwd {sp['fwd'] / ti['fwd']:.4f} bwd "
            f"{sp['bwd'] / ti['bwd']:.4f}; plain fwd {common['fwd_plain']:.4f} bwd "
            f"{common['bwd_plain']:.4f}; vector form fwd {vec_fwd:.4f} bwd {vec_bwd:.4f}; bound "
            f"fwd {common['fwd_bound']:.4f} {common['fwd_by']} bwd {common['bwd_bound']:.4f} "
            f"{common['bwd_by']}; sweep floor (4 / 5 sweeps of q·kᵀ at the bf16 peak and one "
            f"exponential an entry at 16 a clock an SM, {clock:.0f} MHz) fwd "
            f"{floor['fwd']:.4f} bwd {floor['bwd']:.4f}; sdpa fwd {common['fwd_lib']:.4f} bwd "
            f"{common['bwd_lib']:.4f}")
        if not (sp["fwd"] < ti["fwd"] and sp["bwd"] < ti["bwd"]):
            raise RuntimeError(f"streaming {label}: the split kernels are not faster than the "
                               f"tile kernels")
        del q, k, v, g, av, bv
        torch.cuda.empty_cache()
    return times


# The fused q/k/v kernels' checked shapes, [K, N, D, DV]: MobileViT-XS @256
# at batch 128, its three stages of 512 sequences × 4 heads of width 8
# (tools/dispatch_audit.jsonl); ragged N, DV ≠ D, the widest heads and
# rows beyond one block's 256 threads; (label, shape, dtypes)
MVIT_F1, MVIT_F2, MVIT_F3 = (2048, 256, 8, 8), (2048, 64, 8, 8), (2048, 16, 8, 8)
FUSED_SHAPES = [("mobile_vit_xs stage 1", MVIT_F1, ("bfloat16", "float32")),
                ("mobile_vit_xs stage 2", MVIT_F2, ("bfloat16", "float32")),
                ("mobile_vit_xs stage 3", MVIT_F3, ("bfloat16", "float32")),
                ("ragged", (6, 50, 16, 16), ("float32",)),
                ("ragged, DV != D", (5, 100, 8, 24), ("float32", "bfloat16")),
                ("widest", (3, 300, 32, 32), ("float32",))]


def fused_inputs(torch, dev, rng, shape, dtype):
    """q, k [K, N, D] and v, g [K, N, DV], N(0, 1), on the card."""
    kb, n, d, dv = shape
    q, k = (device_normal(torch, dev, rng, (kb, n, d)).to(dtype) for _ in range(2))
    v, g = (device_normal(torch, dev, rng, (kb, n, dv)).to(dtype) for _ in range(2))
    return q, k, v, g


def fused_pairs(fa, torch, q, k, v, g, robust, iters, final_row):
    """(kernel, plain) results of the fused kernels on the same inputs: out,
    vecs, dq, dk, dv."""
    scale = q.shape[-1] ** -0.5
    got = fa.fused_attention_fwd_cuda(q, k, v, scale, robust, iters, final_row)
    got = (*got, *fa.fused_attention_bwd_cuda(q, k, v, g, got[1], scale, robust, iters,
                                              final_row))
    torch.cuda.synchronize()
    want = fa.fused_attention_fwd_plain(q, k, v, scale, robust, iters, final_row)
    want = (*want, *fa.fused_attention_bwd_plain(q, k, v, g, want[1], scale, robust, iters,
                                                 final_row))
    torch.cuda.synchronize()
    return got, want


def phase_fused_kernels(fa, torch, dev):
    """Fused q/k/v kernels against their plain versions. The branch rule
    first: Python's formula against the library's (nrv_fused_resident_fits)
    at every N ≤ 300, D/DV 8/8, 8/16, 16/8 and 4/4, vanilla and robust at 1,
    3, 8 and 9 iterations. Then FUSED_SHAPES, all four MODES (vanilla, (3,
    final), (4, no final), (4, final)): out, the residual rows, dq, dk and
    dv; bf16 at MobileViT-XS's three stages takes the resident kernels, the
    rest (float32, ragged, DV ≠ D, D = 32) the recompute kernels, and each
    call's branch is checked by its launch counts. float32: atol 1e-4, rtol
    1e-3 (the sums run in another order and the reverse chain amplifies
    it); bfloat16 q, k, v (math in float32): out, dq, dk, dv atol and rtol
    2e-2 (one bf16 rounding of values of order one), the float32 residual
    rows atol and rtol 1e-3. Then two runs at each MobileViT-XS stage shape
    give the same bits, bf16 vanilla and (3, final), float32 (3, final).
    Returns the largest errors of (3, final) at the three stage shapes: under
    "resident" the bf16 ones, under "recompute" the float32 ones, each fwd
    (out) and bwd (dq, dk, dv)."""
    from noise_robust_vit_tpu_torch.ops.cuda import build

    lib = build.load_library()
    combos = [(n, d, dv, robust, iters) for n in range(1, 301)
              for d, dv in ((8, 8), (8, 16), (16, 8), (4, 4))
              for robust, iters in ((False, 3), (True, 1), (True, 3), (True, 8), (True, 9))]
    wrong = [c for c in combos
             if bool(lib.nrv_fused_resident_fits(c[0], c[1], c[2], int(c[3]), c[4]))
             != fa._resident_fits(*c)]
    if wrong:
        raise RuntimeError(f"fused branch rule: Python and csrc disagree at {wrong[:5]}")
    log(f"kernels: fused branch rule: Python and the library agree at {len(combos)} shapes; "
        f"resident at bf16 D = DV = 8, N ≤ {max(c[0] for c in combos if fa._resident_fits(*c))}")
    worst = {b: {"fwd": 0.0, "bwd": 0.0} for b in ("resident", "recompute")}
    rng = np.random.default_rng(50)
    names = ["out", "vecs", "dq", "dk", "dv"]
    for label, shape, dnames in FUSED_SHAPES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            bf16 = dtype == torch.bfloat16
            q, k, v, g = fused_inputs(torch, dev, rng, shape, dtype)
            for mode in MODES:
                branch = fa.fused_branch(shape[1], shape[2], shape[3], dtype, mode[0], mode[1])
                counts = {b: getattr(fa, f"launches_{b}") for b in ("resident", "recompute")}
                for c in counts.values():
                    c.reset()
                got, want = fused_pairs(fa, torch, q, k, v, g, *mode)
                if any((c.fwd, c.bwd) != ((1, 1) if b == branch else (0, 0))
                       for b, c in counts.items()):
                    raise RuntimeError(f"fused {label} {dname}: expected one {branch} launch "
                                       "each way and no other")
                errs = {nm: (a.float() - b.float()).abs().max().item()
                        for nm, a, b in zip(names, got, want)}
                log(f"kernels: fused {label} {dname} {list(shape)} {branch} robust="
                    f"{int(mode[0])} iters={mode[1]} final_row={int(mode[2])} max_abs_err "
                    + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items()))
                for nm, a, b in zip(names, got, want):
                    if nm == "vecs":
                        torch.testing.assert_close(a, b, atol=1e-3 if bf16 else 1e-4, rtol=1e-3,
                                                   msg=nm)
                    elif bf16:
                        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2,
                                                   msg=nm)
                    else:
                        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=nm)
                stage = label.startswith("mobile_vit")
                if stage and mode == (True, 3, True):
                    w = worst[branch]
                    w["fwd"] = max(w["fwd"], errs["out"])
                    w["bwd"] = max(w["bwd"], errs["dq"], errs["dk"], errs["dv"])
                if stage and (mode == (True, 3, True) or (bf16 and mode == MODES[0])):
                    again = fused_pairs(fa, torch, q, k, v, g, *mode)[0]
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise RuntimeError(f"fused {branch}: two runs gave different bits")
                    log(f"kernels: fused {list(shape)} {dname} {branch} robust={int(mode[0])}: "
                        f"two runs give the same bits (out, vecs, dq, dk, dv)")
                    del again
                del got, want
            del q, k, v, g
            torch.cuda.empty_cache()
    return worst


MVIT_SMALL = dict(num_classes=10, dims=(16, 24, 16),
                  channels=(8, 8, 12, 16, 16, 24, 24, 24, 24, 32, 48), depths=(1, 1, 1))


def phase_small_mobile_vit(fa, torch, dev):
    """The MobileViT wiring through the fused kernels: a small robust float32
    MobileViT (dims 16/24/16, depth 1 a stage, 4 heads of 8) at 128 px,
    whose transformers attend over 64, 16 and 4 tokens, on the card against
    the same weights on the CPU, in train mode: logits, every parameter
    gradient and the BN running statistics after the step (atol 1e-4, rtol
    1e-3, as LeViT's and CvT's). Every parameter is perturbed from a seed.
    3 fused launches each way on the card (float32: the recompute kernels),
    none on the CPU. Returns the card's recompute launches (fwd, bwd)."""
    from noise_robust_vit_tpu_torch import MobileViT

    gen = torch.Generator().manual_seed(51)
    cpu = MobileViT(robust=True, device="cpu", **MVIT_SMALL)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    gpu = MobileViT(robust=True, device=dev, **MVIT_SMALL)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.standard_normal((4, 128, 128, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    outs = []
    for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        model.train()
        for c in (fa.launches, fa.launches_recompute):
            c.reset()
        logits = model(xx)
        torch.nn.functional.cross_entropy(logits.float(), yy).backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()},
                     (fa.launches.fwd, fa.launches.bwd),
                     (fa.launches_recompute.fwd, fa.launches_recompute.bwd)))
    if outs[0][3] != (0, 0) or outs[1][3] != (3, 3) or outs[1][4] != (3, 3):
        raise RuntimeError(f"small mobile_vit: fused launches cpu {outs[0][3]}, card "
                           f"{outs[1][3]}, expected (0, 0) and (3, 3)")
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    for i in (1, 2):
        for k, v in outs[0][i].items():
            torch.testing.assert_close(outs[1][i][k], v, atol=1e-4, rtol=1e-3, msg=k)
    err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
    err_bn = max((outs[1][2][k] - v).abs().max().item() for k, v in outs[0][2].items())
    log(f"slice: small MobileViT f32 robust 128 px train mode card vs cpu: logits, grads and "
        f"BN running stats agree (max grad err {err:.3g}, stats {err_bn:.3g}), fused launches "
        f"3/3 on the card (recompute branch), 0 on the cpu")
    return {"fwd": outs[1][4][0], "bwd": outs[1][4][1]}


def fused_bounds(q, v, vecs, robust):
    """(fwd, bwd) bounds of a fused call from its inputs (attention_work): the
    bytes each direction must move once, the products on the bf16 tensor
    cores and the float32 passes."""
    kb, n, d = q.shape
    qkv_b = 3 * q.numel() * q.element_size()
    out_b, vec_b = v.numel() * v.element_size(), vecs.numel() * 4
    return attention_work(kb, n, d, v.shape[2], (qkv_b, qkv_b + out_b + vec_b),
                          (out_b + vec_b, qkv_b), robust, 3, True, 0)


def phase_fused_times(fa, ba, torch, dev):
    """Fused kernels at MobileViT-XS's three stage shapes ([512, 4, N, 8] as
    [2048, N, 8], N = 256, 64, 16, bf16), robust (3, final) and vanilla: the
    resident and the recompute kernels in turns (resident, recompute,
    recompute, resident; the mean of each pair), beside their plain versions
    and, for vanilla, scaled_dot_product_attention (the library yardstick).
    At stage 1 the resident kernels must beat the recompute ones in both
    modes and directions, and the vector form (``ops.dot_product_attention``
    with the fused dispatch off: float32 logits, softmax, the scaling
    vectors, attn·v; its backward through autograd) is timed too; at stages
    2 and 3 the biased kernels with no bias (robust), which keep each item's
    N×N matrix in shared memory. Then the recompute kernels alone at stage 1
    in float32, robust, the dtype that takes them. Returns the times by
    (stage, robust) and under "f32", each with its plain, library and bound
    entries."""
    from noise_robust_vit_tpu_torch import ops

    rng = np.random.default_rng(53)
    times = {}
    for label, shape in (("stage 1", MVIT_F1), ("stage 2", MVIT_F2), ("stage 3", MVIT_F3)):
        kb, n, d, dv = shape
        scale = d ** -0.5
        q, k, v, g = fused_inputs(torch, dev, rng, shape, torch.bfloat16)
        heads = [x.reshape(kb // 4, 4, n, -1) for x in (q, k, v, g)]
        for robust in (True, False):
            _, vecs = fa.fused_attention_fwd_cuda(q, k, v, scale, robust)
            runs = {}
            for branch in ("resident", "recompute", "recompute", "resident"):
                runs.setdefault(branch, []).append((
                    cuda_ms(lambda: fa.fused_attention_fwd_cuda(q, k, v, scale, robust,
                                                                branch=branch), 20),
                    cuda_ms(lambda: fa.fused_attention_bwd_cuda(q, k, v, g, vecs, scale, robust,
                                                                branch=branch), 20)))
            t = {"fwd_plain": cuda_ms(lambda: fa.fused_attention_fwd_plain(q, k, v, scale,
                                                                           robust), 3),
                 "bwd_plain": cuda_ms(lambda: fa.fused_attention_bwd_plain(q, k, v, g, vecs,
                                                                           scale, robust), 3),
                 "fwd_lib": None, "bwd_lib": None}
            if not robust:
                t["fwd_lib"], t["bwd_lib"] = sdpa_ms(torch, *heads[:3], None, heads[3])
            (t["fwd_bound"], t["fwd_by"]), (t["bwd_bound"], t["bwd_by"]) = fused_bounds(
                q, v, vecs, robust)
            for branch, pairs in runs.items():
                t[branch] = {"fwd": statistics.mean(p[0] for p in pairs),
                             "bwd": statistics.mean(p[1] for p in pairs)}
            new, old = t["resident"], t["recompute"]
            lib = "" if robust else f"; sdpa fwd {t['fwd_lib']:.4f} bwd {t['bwd_lib']:.4f}"
            log(f"timing: fused attention bf16 MobileViT-XS {label} [{kb},{n},{d}] robust="
                f"{int(robust)}{' (3, final)' if robust else ''} ms: resident fwd "
                f"{new['fwd']:.4f} {[round(p[0], 4) for p in runs['resident']]} bwd "
                f"{new['bwd']:.4f} {[round(p[1], 4) for p in runs['resident']]}; recompute fwd "
                f"{old['fwd']:.4f} {[round(p[0], 4) for p in runs['recompute']]} bwd "
                f"{old['bwd']:.4f} {[round(p[1], 4) for p in runs['recompute']]}; plain fwd "
                f"{t['fwd_plain']:.4f} bwd {t['bwd_plain']:.4f}; bound fwd {t['fwd_bound']:.4f} "
                f"{t['fwd_by']} bwd {t['bwd_bound']:.4f} {t['bwd_by']}{lib}; resident/recompute "
                f"fwd {new['fwd'] / old['fwd']:.4f} bwd {new['bwd'] / old['bwd']:.4f}")
            if label == "stage 1":
                if not (new["fwd"] < old["fwd"] and new["bwd"] < old["bwd"]):
                    raise RuntimeError(f"fused stage 1 robust={int(robust)}: the resident "
                                       "kernels are not faster than the recompute kernels")
                real = ops.attention.fused_dispatch
                ops.attention.fused_dispatch = lambda *a, **kw: False
                try:
                    vec_fwd = cuda_ms(lambda: ops.dot_product_attention(*heads[:3],
                                                                        robust=robust), 5)
                    leaves = [x.detach().requires_grad_(True) for x in heads[:3]]
                    out = ops.dot_product_attention(*leaves, robust=robust)
                    vec_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, heads[3],
                                                                  retain_graph=True), 5)
                finally:
                    ops.attention.fused_dispatch = real
                del out, leaves
                log(f"timing: fused attention stage 1 robust={int(robust)}: the vector form fwd "
                    f"{vec_fwd:.4f} bwd {vec_bwd:.4f} ms")
            elif robust:
                bias = torch.zeros(1, 4, n, n, device=dev)
                args = (scale, True, 3, True, 1, True)
                _, bvecs = ba.biased_attention_fwd_cuda(*heads[:3], bias, *args)
                bt = (cuda_ms(lambda: ba.biased_attention_fwd_cuda(*heads[:3], bias, *args), 20),
                      cuda_ms(lambda: ba.biased_attention_bwd_cuda(*heads[:3], bias, heads[3],
                                                                   bvecs, *args), 20))
                log(f"timing: fused attention {label} robust=1: the matrix in shared memory "
                    f"(biased kernels, no bias) fwd {bt[0]:.4f} bwd {bt[1]:.4f} ms")
                del bias, bvecs
            times[label, robust] = t
            del vecs
        del q, k, v, g, heads
    kb, n, d, dv = MVIT_F1
    q, k, v, g = fused_inputs(torch, dev, rng, MVIT_F1, torch.float32)
    _, vecs = fa.fused_attention_fwd_cuda(q, k, v, d ** -0.5, True)
    t = {"fwd": cuda_ms(lambda: fa.fused_attention_fwd_cuda(q, k, v, d ** -0.5, True), 10),
         "bwd": cuda_ms(lambda: fa.fused_attention_bwd_cuda(q, k, v, g, vecs, d ** -0.5, True),
                        10),
         "fwd_plain": cuda_ms(lambda: fa.fused_attention_fwd_plain(q, k, v, d ** -0.5, True), 3),
         "bwd_plain": cuda_ms(lambda: fa.fused_attention_bwd_plain(q, k, v, g, vecs, d ** -0.5,
                                                                   True), 3),
         "fwd_lib": None, "bwd_lib": None}
    (t["fwd_bound"], t["fwd_by"]), (t["bwd_bound"], t["bwd_by"]) = fused_bounds(
        q, v, vecs, True)
    log(f"timing: fused attention float32 stage 1 [{kb},{n},{d}] recompute robust=1 (3, final) "
        f"ms: fwd {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} "
        f"{t['fwd_by']}) bwd {t['bwd']:.4f} (plain {t['bwd_plain']:.4f}, bound "
        f"{t['bwd_bound']:.4f} {t['bwd_by']})")
    times["f32"] = t
    del q, k, v, g, vecs
    torch.cuda.empty_cache()
    return times


# The fused LayerNorm kernels' checked shapes, (rows, D, dtypes): SimpleViT-B/16
# at batch 256 ([256·196, 768] bf16, its 24 + 24 calls a step), D of 128,
# 1024 (the last warp-per-row width), 1280 (vit_h's width, one block a row)
# and 8192 (the gate's largest), ragged row counts
LN_MAIN = (50176, 768)
LN_SHAPES = [(*LN_MAIN, ("bfloat16", "float32")), (500, 128, ("float32", "bfloat16")),
             (1, 768, ("bfloat16",)), (500, 1024, ("float32", "bfloat16")),
             (500, 1280, ("float32", "bfloat16")), (63, 8192, ("float32", "bfloat16")),
             (1, 8192, ("float32",))]


def ln_inputs(torch, dev, rng, rows, d, dtype):
    """x (N(1, 3²)), scale near 1, bias, dy (N(0, 1)) on the card."""
    x = (1 + 3 * device_normal(torch, dev, rng, (rows, d))).to(dtype)
    g = 1 + 0.2 * device_normal(torch, dev, rng, d)
    b = 0.1 * device_normal(torch, dev, rng, d)
    dy = device_normal(torch, dev, rng, (rows, d)).to(dtype)
    return x, g, b, dy


def ln_pairs(fl, torch, x, g, b, dy):
    """(kernel, plain) results on the same inputs: y, dx, dscale, dbias."""
    got = (fl.fused_ln_fwd_cuda(x, g, b), *fl.fused_ln_bwd_cuda(x, g, dy))
    torch.cuda.synchronize()
    want = (fl.fused_ln_fwd_plain(x, g, b), *fl.fused_ln_bwd_plain(x, g, dy))
    torch.cuda.synchronize()
    return got, want


def phase_ln_kernels(fl, torch, dev):
    """Fused LayerNorm kernels against their plain versions at LN_SHAPES: y
    and dx float32 atol and rtol 1e-5 (rsqrt and the sums' order differ),
    bfloat16 one bf16 ulp (rtol 8e-3, atol 1e-2 near 0); dscale and dbias,
    sums over every row in another order, rtol 1e-4 and atol 1e-5 of the
    tensor's largest magnitude. Then two runs at the main path's shape give
    the same bits, and a D outside the gate (96) is refused by the kernel
    wrappers and launches nothing through FusedLayerNorm. Returns the largest
    bfloat16 errors at the main path's shape: fwd (y), bwd (dx, dscale,
    dbias)."""
    from noise_robust_vit_tpu_torch.ops.norms import FusedLayerNorm

    worst = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(60)
    names = ["y", "dx", "dscale", "dbias"]
    for rows, d, dnames in LN_SHAPES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            bf16 = dtype == torch.bfloat16
            x, g, b, dy = ln_inputs(torch, dev, rng, rows, d, dtype)
            got, want = ln_pairs(fl, torch, x, g, b, dy)
            errs = {nm: (a.float() - w.float()).abs().max().item()
                    for nm, a, w in zip(names, got, want)}
            log(f"kernels: fused_ln {dname} [{rows},{d}] max_abs_err "
                + " ".join(f"{nm}={e:.3g}" for nm, e in errs.items()))
            for nm, a, w in zip(names, got, want):
                if nm in ("dscale", "dbias"):
                    torch.testing.assert_close(a, w, atol=1e-5 * w.abs().max().item(),
                                               rtol=1e-4, msg=nm)
                elif bf16:
                    torch.testing.assert_close(a.float(), w.float(), atol=1e-2, rtol=8e-3, msg=nm)
                else:
                    torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5, msg=nm)
            if (rows, d) == LN_MAIN and bf16:
                worst["fwd"] = errs["y"]
                worst["bwd"] = max(errs["dx"], errs["dscale"], errs["dbias"])
                again = ln_pairs(fl, torch, x, g, b, dy)[0]
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise RuntimeError("fused_ln: two runs gave different bits")
                log(f"kernels: fused_ln [{rows},{d}] {dname}: two runs give the same bits "
                    f"(y, dx, dscale, dbias)")
                del again
            del x, g, b, dy, got, want
        torch.cuda.empty_cache()
    x, g, b, dy = ln_inputs(torch, dev, rng, 64, 96, torch.float32)
    for fn, args in ((fl.fused_ln_fwd_cuda, (x, g, b)), (fl.fused_ln_bwd_cuda, (x, g, dy))):
        try:
            fn(*args)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"fused_ln: {fn.__name__} took D = 96")
    mod = FusedLayerNorm(96, device=dev)
    xx = x.clone().requires_grad_(True)
    fl.launches.reset()
    mod(xx).backward(dy)
    torch.cuda.synchronize()
    if (fl.launches.fwd, fl.launches.bwd) != (0, 0):
        raise RuntimeError(f"fused_ln: D = 96 launched {(fl.launches.fwd, fl.launches.bwd)}")
    log("kernels: fused_ln D = 96 (outside the gate): refused by the kernel wrappers, no launch "
        "through FusedLayerNorm")
    return worst


def card_vs_cpu(torch, dev, build, x, y, counts, train=False):
    """``build(device)`` on the CPU and on the card with the CPU model's
    state: logits, every parameter gradient and the buffers after one
    forward and backward (atol 1e-4, rtol 1e-3), and the launches of each
    counter on each side. Returns the largest gradient and buffer errors and
    the launches (cpu, card)."""
    cpu = build("cpu")
    gpu = build(dev)
    gpu.load_state_dict(cpu.state_dict())
    outs = []
    for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        model.train(train)
        for c in counts.values():
            c.reset()
        logits = model(xx)
        torch.nn.functional.cross_entropy(logits.float(), yy).backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()},
                     {k: (c.fwd, c.bwd) for k, c in counts.items()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    for i in (1, 2):
        for k, v in outs[0][i].items():
            torch.testing.assert_close(outs[1][i][k], v, atol=1e-4, rtol=1e-3, msg=k)
    err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
    err_bn = max([(outs[1][2][k] - v).abs().max().item() for k, v in outs[0][2].items()],
                 default=0.0)
    return err, err_bn, outs[0][3], outs[1][3]


def phase_small_fused_ln_model(fl, pa, torch, dev):
    """The model wiring through the kernels: a small robust float32
    SimpleViT (dim 128, depth 2, its block norms on the fused LayerNorm) on
    the card against the same weights on the CPU (plain versions). Every
    parameter is perturbed from a seed. 4 fused-LN and 2 packed launches
    each way on the card, none on the CPU."""
    from noise_robust_vit_tpu_torch import SimpleViT

    kw = dict(num_classes=10, image_size=64, patch_size=8, robust=True, dim=128, depth=2,
              heads=2, mlp_dim=256, dim_head=64)
    gen = torch.Generator().manual_seed(61)

    def build(device):
        model = SimpleViT(device=device, **kw)
        if device == "cpu":
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
        return model

    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    counts = {"fused_ln": fl.launches, "packed": pa.launches}
    err, _, on_cpu, on_card = card_vs_cpu(torch, dev, build, x, y, counts)
    want = {"fused_ln": (4, 4), "packed": (2, 2)}
    if on_card != want or any(v != (0, 0) for v in on_cpu.values()):
        raise RuntimeError(f"small SimpleViT: launches cpu {on_cpu}, card {on_card}, "
                           f"expected 0s and {want}")
    log(f"slice: small SimpleViT f32 robust card vs cpu: logits and grads agree "
        f"(max grad err {err:.3g}), launches fused_ln 4/4, packed 2/2 on the card, 0 on the cpu")


VIT_SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=64,
                 mlp_dim=128, num_classes=10)


def phase_small_vit(pa, fl, torch, dev):
    """The VisionTransformer wiring through the packed kernels: small robust
    float32 models (32 px, patch 8, 2 layers of 2 heads × 32), with the patch
    stem in eval mode and the conv-BN-ReLU stem in train mode (BN running
    statistics), on the card against the same weights on the CPU. Every
    parameter is perturbed from a seed (the head is zero at init). 2 packed
    launches each way on the card, none on the CPU, no fused-LN launch."""
    from noise_robust_vit_tpu_torch import VisionTransformer
    from noise_robust_vit_tpu_torch.models.vision_transformer import ConvStemConfig

    rng = np.random.default_rng(63)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    counts = {"packed": pa.launches, "fused_ln": fl.launches}
    stem = [ConvStemConfig(16, 3, 2), ConvStemConfig(24, 3, 2), ConvStemConfig(32, 3, 2)]
    for label, extra, train in (("patch stem", {}, False),
                                ("conv stem train mode", {"conv_stem_configs": stem}, True)):
        gen = torch.Generator().manual_seed(64)

        def build(device):
            model = VisionTransformer(robust=True, device=device, **VIT_SMALL, **extra)
            if device == "cpu":
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(0.1 * torch.randn(p.shape, generator=gen))
            return model

        err, err_bn, on_cpu, on_card = card_vs_cpu(torch, dev, build, x, y, counts, train)
        want = {"packed": (2, 2), "fused_ln": (0, 0)}
        if on_card != want or any(v != (0, 0) for v in on_cpu.values()):
            raise RuntimeError(f"small VisionTransformer {label}: launches cpu {on_cpu}, card "
                               f"{on_card}, expected 0s and {want}")
        log(f"slice: small VisionTransformer f32 robust {label} card vs cpu: logits, grads "
            f"and buffers agree (max grad err {err:.3g}, stats {err_bn:.3g}), packed launches "
            f"2/2 on the card, 0 on the cpu")


def phase_vit_train(pa, fl, torch, dev, counts):
    """phase_train for vit_b_16, recording the schedule of every packed
    forward launch: (robust, 4, no final row norm) in each mode."""
    real = pa.packed_attention_fwd_cuda
    seen = []

    def spy(qkv, heads, dim_head, scale, robust=False, iters=3, final_row=True):
        seen.append((bool(robust), int(iters), bool(final_row)))
        return real(qkv, heads, dim_head, scale, robust, iters, final_row)

    pa.packed_attention_fwd_cuda = spy
    try:
        total = phase_train(counts, torch, dev, "vit_b_16",
                            {r: {"packed": 12, "packed_resident": 12, "packed_scratch": 0,
                                 "fused_ln": 0} for r in (True, False)})
    finally:
        pa.packed_attention_fwd_cuda = real
    if sorted(set(seen)) != [(False, 4, False), (True, 4, False)]:
        raise RuntimeError(f"vit_b_16: packed schedules {sorted(set(seen))}")
    log(f"slice: vit_b_16 packed forward launches ran (robust, iters, final_row) "
        f"{sorted(set(seen))}")
    return total


def phase_ln_times(fl, torch, dev, shape=LN_MAIN):
    """Fused LayerNorm kernels at SimpleViT-B/16's [50176, 768] bf16 beside
    their plain versions, F.layer_norm on the same x (bf16 x, weight and
    bias, the weight and bias rounded to bf16: it takes no mixed types; its
    backward to x, weight and bias through autograd: the library
    yardstick) and the port's eager LayerNorm module (x to
    float32, F.layer_norm, back to bf16: what the blocks ran before they
    took the kernels, and still run at a width outside the gate). Bounds
    from these inputs: forward reads x, scale, bias and writes y; backward
    reads x, dy, scale and writes dx, dscale, dbias; ~8 and ~16 float32
    operations an element."""
    from noise_robust_vit_tpu_torch.models.layers import LayerNorm

    rows, d = shape
    rng = np.random.default_rng(65)
    x, g, b, dy = ln_inputs(torch, dev, rng, rows, d, torch.bfloat16)
    t = {"fwd": cuda_ms(lambda: fl.fused_ln_fwd_cuda(x, g, b), 20),
         "fwd_plain": cuda_ms(lambda: fl.fused_ln_fwd_plain(x, g, b), 10),
         "bwd": cuda_ms(lambda: fl.fused_ln_bwd_cuda(x, g, dy), 20),
         "bwd_plain": cuda_ms(lambda: fl.fused_ln_bwd_plain(x, g, dy), 10)}
    ln = torch.nn.functional.layer_norm
    gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
    t["fwd_lib"] = cuda_ms(lambda: ln(x, (d,), gb, bb, 1e-5), 20)
    leaves = [v.detach().requires_grad_(True) for v in (x, gb, bb)]
    out = ln(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
    t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), 20)
    eager = LayerNorm(d, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        eager.weight.copy_(g)
        eager.bias.copy_(b)
    eager_fwd = cuda_ms(lambda: eager(x), 20)
    xe = x.detach().requires_grad_(True)
    out_e = eager(xe)
    params = [xe, eager.weight, eager.bias]
    eager_bwd = cuda_ms(lambda: torch.autograd.grad(out_e, params, dy, retain_graph=True), 20)
    el = x.numel()
    act, vec = el * 2, d * 4
    t["fwd_bound"], t["fwd_by"] = bound_ms(2 * act + 2 * vec, 0, 8 * el)
    t["bwd_bound"], t["bwd_by"] = bound_ms(3 * act + 3 * vec, 0, 16 * el)
    t["eager_fwd"], t["eager_bwd"] = eager_fwd, eager_bwd
    log(f"timing: fused_ln bf16 [{rows},{d}] ms: fwd {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, "
        f"bound {t['fwd_bound']:.4f} {t['fwd_by']}) bwd {t['bwd']:.4f} (plain "
        f"{t['bwd_plain']:.4f}, bound {t['bwd_bound']:.4f} {t['bwd_by']}); F.layer_norm (bf16 "
        f"x, weight and bias) fwd {t['fwd_lib']:.4f} bwd {t['bwd_lib']:.4f}; the port's "
        f"eager LayerNorm (f32 math, bf16 out) fwd {eager_fwd:.4f} bwd {eager_bwd:.4f}")
    del x, g, b, gb, bb, dy, leaves, out, xe, out_e, params
    torch.cuda.empty_cache()
    return t


RESIDENT_SOURCES = ("packed_resident_fwd.cu", "packed_resident_bwd.cu", "fused_resident_fwd.cu",
                    "fused_resident_bwd.cu", "biased_resident_fwd.cu", "biased_resident_bwd.cu")


def ptxas_report(build, lib_path):
    """The resident packed, fused and biased kernels' registers, shared
    memory and spills, from the build's -Xptxas -v report."""
    section = None
    for line in build.ptxas_log(lib_path).read_text().splitlines():
        if line.startswith("== "):
            section = line[3:]
        elif section in RESIDENT_SOURCES and any(
                w in line for w in ("registers", "spill", "stack frame")):
            log(f"build: ptxas {section}: {line.strip()}")


def kernel_entry(name, src, replaces, launches, err, t, direction):
    """One row of the {"kernels": [...]} line: the times ``t`` of the robust
    schedule the row's path runs."""
    return {"name": name, "route": "cuda", "source": CSRC + src, "replaces": PALLAS + replaces,
            "launches": launches, "max_abs_err": err, "ms": t[direction],
            "plain_ms": t[direction + "_plain"], "bound_ms": t[direction + "_bound"],
            "bound_by": t[direction + "_by"], "library_ms": t[direction + "_lib"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lap = lap_clock()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba
    from noise_robust_vit_tpu_torch.ops.cuda import build
    from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa
    from noise_robust_vit_tpu_torch.ops.cuda import fused_ln as fl
    from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa
    from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss
    from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa
    from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    ptxas_report(build, lib_path)
    lap("build")

    worst = phase_kernels(pa, torch, dev)
    lap("packed kernel checks")
    worst_b = phase_biased_kernels(ba, torch, dev)
    lap("biased kernel checks")
    worst_s = phase_sinkhorn_kernels(ss, torch, dev)
    lap("sinkhorn softmax kernel checks")
    worst_t = phase_th_kernels(th, torch, dev)
    lap("talking-heads kernel checks")
    worst_st = phase_stream_kernels(sa, torch, dev)
    lap("streaming kernel checks")
    worst_f = phase_fused_kernels(fa, torch, dev)
    lap("fused kernel checks")
    worst_ln = phase_ln_kernels(fl, torch, dev)
    torch.cuda.synchronize()
    lap("fused LayerNorm kernel checks")
    # the small float32 models take the scratch branch of the packed kernels
    pa.launches_scratch.reset()
    phase_small_swin(ba, torch, dev)
    phase_small_levit(ba, ss, torch, dev)
    th_plane_launches = phase_small_cait(th, torch, dev)
    stream_tile_launches = phase_small_cvt(sa, ss, torch, dev)
    recompute_launches = phase_small_mobile_vit(fa, torch, dev)
    phase_small_fused_ln_model(fl, pa, torch, dev)
    phase_small_vit(pa, fl, torch, dev)
    torch.cuda.synchronize()
    scratch_launches = {"fwd": pa.launches_scratch.fwd, "bwd": pa.launches_scratch.bwd}
    log(f"slice: the small float32 models launched the scratch packed kernels "
        f"{scratch_launches['fwd']}/{scratch_launches['bwd']} times")
    if not (scratch_launches["fwd"] and scratch_launches["bwd"]):
        raise RuntimeError("the small models did not launch the scratch packed kernels")
    lap("small models card vs cpu")
    # the fused q/k/v kernels serve MobileViT's transformers and no site of
    # the earlier models: their paths count 0 fused launches; the fused
    # LayerNorm serves SimpleViT's block norms (D 768) and no other model's
    # every SimpleViT-B/16 and vit_b_16 step runs its 12 + 12 packed
    # launches on the resident branch
    packed = {"packed": pa.launches, "packed_resident": pa.launches_resident,
              "packed_scratch": pa.launches_scratch}
    on_resident = {"packed": 12, "packed_resident": 12, "packed_scratch": 0}
    counts_s = phase_train({**packed, "fused": fa.launches, "fused_ln": fl.launches},
                           torch, dev, "simple_vit_b16",
                           {r: {**on_resident, "fused": 0, "fused_ln": 24}
                            for r in (True, False)})
    counts = counts_s["packed_resident"]
    counts_v = phase_vit_train(pa, fl, torch, dev, {**packed, "fused_ln": fl.launches})
    # every robust Swin-T step runs its 12 + 12 biased launches on the
    # resident branch; LeViT-128S 7 resident (N = 49, 16) and 2 shared (N =
    # 196) each way
    biased = {"biased": ba.launches, "biased_resident": ba.launches_resident,
              "biased_shared": ba.launches_shared}
    counts_b = phase_train({**biased, "fused": fa.launches, "fused_ln": fl.launches},
                           torch, dev, "swin_t",
                           {True: {"biased": 12, "biased_resident": 12, "biased_shared": 0,
                                   "fused": 0, "fused_ln": 0},
                            False: {"biased": 0, "biased_resident": 0, "biased_shared": 0,
                                    "fused": 0, "fused_ln": 0}})["biased_resident"]
    phase_swin_v2(ba, torch, dev)
    levit_counts = {**biased, "rect": ss.launches_rect, "square": ss.launches,
                    "fused": fa.launches, "fused_ln": fl.launches}
    counts_l = phase_train(levit_counts, torch, dev, "levit",
                           {True: {"biased": 9, "biased_resident": 7, "biased_shared": 2,
                                   "rect": 2, "square": 0, "fused": 0, "fused_ln": 0},
                            False: {"biased": 0, "biased_resident": 0, "biased_shared": 0,
                                    "rect": 0, "square": 0, "fused": 0, "fused_ln": 0}})
    phase_levit_256(ba, ss, torch, dev)
    counts_sq = phase_square_path(ss, torch, dev)
    # every robust CaiT step runs its 6 + 6 talking-heads launches on the
    # cluster branch
    cait_counts = {"talking_heads": th.launches, "talking_heads_cluster": th.launches_cluster,
                   "talking_heads_plane": th.launches_plane, "square": ss.launches,
                   "rect": ss.launches_rect, "fused": fa.launches, "fused_ln": fl.launches}
    counts_t = phase_train(cait_counts, torch, dev, "cait",
                           {r: {"talking_heads": 6 if r else 0,
                                "talking_heads_cluster": 6 if r else 0, "talking_heads_plane": 0,
                                "square": 0, "rect": 0, "fused": 0, "fused_ln": 0}
                            for r in (True, False)})
    # every robust CvT-13 step runs its 3 + 3 streaming launches on the
    # split branch (bf16, D = 64)
    cvt_counts = {"streaming": sa.launches, "streaming_split": sa.launches_split,
                  "streaming_tile": sa.launches_tile, "rect": ss.launches_rect,
                  "square": ss.launches, "biased": ba.launches, "fused": fa.launches,
                  "fused_ln": fl.launches}
    counts_c = phase_train(cvt_counts, torch, dev, "cvt_13",
                           {True: {"streaming": 3, "streaming_split": 3, "streaming_tile": 0,
                                   "rect": 10, "square": 0, "biased": 0, "fused": 0,
                                   "fused_ln": 0},
                            False: {"streaming": 0, "streaming_split": 0, "streaming_tile": 0,
                                    "rect": 0, "square": 0, "biased": 0, "fused": 0,
                                    "fused_ln": 0}})
    # every robust MobileViT-XS step runs its 9 + 9 fused launches on the
    # resident branch
    mvit_counts = {"fused": fa.launches, "fused_resident": fa.launches_resident,
                   "fused_recompute": fa.launches_recompute, "packed": pa.launches,
                   "biased": ba.launches, "streaming": sa.launches, "square": ss.launches,
                   "rect": ss.launches_rect, "fused_ln": fl.launches}
    counts_m = phase_train(mvit_counts, torch, dev, "mobile_vit_xs",
                           {r: {"fused": 9 if r else 0, "fused_resident": 9 if r else 0,
                                "fused_recompute": 0, "packed": 0, "biased": 0, "streaming": 0,
                                "square": 0, "rect": 0, "fused_ln": 0} for r in (True, False)},
                           image=256)
    torch.cuda.synchronize()
    lap("train phases")
    ktimes = phase_kernel_times(pa, torch, dev)
    ktimes_v = phase_kernel_times(pa, torch, dev, n=197, iters=4, final_row=False)
    # the scratch kernels' own row: float32, the dtype that takes them
    ktimes_f32 = phase_kernel_times(pa, torch, dev, dtype=torch.float32, robusts=(True,))
    lap("packed timing")
    btimes = phase_biased_times(ba, torch, dev)
    # the resident kernels' row: Swin-T stage 0, robust (3, final)
    biased_row = dict(btimes[True], **btimes[True]["resident"])
    btimes_levit = phase_biased_levit_times(ba, torch, dev)
    lap("biased timing")
    stimes = phase_sinkhorn_times(ss, torch, dev)
    lap("sinkhorn softmax timing")
    ttimes = phase_th_times(th, torch, dev)
    lap("talking-heads timing")
    sttimes = phase_stream_times(sa, torch, dev)
    lap("streaming timing")
    ftimes = phase_fused_times(fa, ba, torch, dev)
    # the resident kernels' row: MobileViT-XS stage 1, robust (3, final)
    fused_row = dict(ftimes["stage 1", True], **ftimes["stage 1", True]["resident"])
    lap("fused timing")
    ln_times = phase_ln_times(fl, torch, dev)
    torch.cuda.synchronize()
    lap("fused LayerNorm timing")
    phase_step_times(torch, dev, "simple_vit_b16", 256, vit_train_flops_per_image())
    flops_v = vit_train_flops_per_image(cls_token=True)
    log(f"timing: vit_b_16 train FLOPs per image {flops_v / 1e9:.4f} G (197 tokens)")
    rates_vit = phase_step_times(torch, dev, "vit_b_16", 256, flops_v)
    log(f"timing: vit_b_16 robust/vanilla img/s ratio {rates_vit[True] / rates_vit[False]:.4f}")
    macs = swin_fwd_macs_per_image()
    log(f"timing: swin_t forward {macs / 1e9:.4f} GMACs per image (torchvision "
        f"publishes 4.49 GFLOPS, counted as multiply-adds)")
    phase_step_times(torch, dev, "swin_t", 128, 3 * 2 * macs)
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.models.levit import levit_macs_per_image

    macs_l = levit_macs_per_image(create_model("levit", num_classes=1000, device="meta"))
    log(f"timing: LeViT_128S forward {macs_l / 1e6:.4f} M MACs per image (the LeViT paper "
        f"publishes 305 M FLOPs, counted as multiply-adds; gap {macs_l / 305e6 - 1:+.4%})")
    phase_step_times(torch, dev, "levit", 256, 3 * 2 * macs_l)
    from noise_robust_vit_tpu_torch.models.cait import cait_macs_per_image

    macs_c = cait_macs_per_image(create_model("cait", num_classes=1000, device="meta"))
    log(f"timing: cait forward {macs_c / 1e9:.4f} GMACs per image (patch projection, every "
        f"Dense, q·kᵀ and attn·v of both stages, head)")
    rates_c = phase_step_times(torch, dev, "cait", 128, 3 * 2 * macs_c)
    log(f"timing: cait robust/vanilla img/s ratio {rates_c[True] / rates_c[False]:.4f}")
    from noise_robust_vit_tpu_torch.models.cvt import cvt_macs_per_image

    macs_v = cvt_macs_per_image(create_model("cvt_13", num_classes=1000, device="meta"))
    log(f"timing: cvt_13 forward {macs_v / 1e9:.4f} GMACs per image (conv embeddings, "
        f"depthwise and pointwise projections, q·kᵀ and attn·v, to_out, the 1×1 FFN, head; "
        f"the CvT paper publishes 4.5 G)")
    rates_v = phase_step_times(torch, dev, "cvt_13", 128, 3 * 2 * macs_v)
    log(f"timing: cvt_13 robust/vanilla img/s ratio {rates_v[True] / rates_v[False]:.4f}")
    from noise_robust_vit_tpu_torch.models.mobile_vit import mobile_vit_macs_per_image

    macs_m = mobile_vit_macs_per_image(create_model("mobile_vit_xs", num_classes=1000,
                                                    device="meta"))
    log(f"timing: mobile_vit_xs forward {macs_m / 1e9:.4f} GMACs per image at 256 px "
        f"(convolutions, the transformers' Dense layers, q·kᵀ and attn·v, head)")
    rates_m = phase_step_times(torch, dev, "mobile_vit_xs", 128, 3 * 2 * macs_m, image=256)
    log(f"timing: mobile_vit_xs robust/vanilla img/s ratio {rates_m[True] / rates_m[False]:.4f}")
    torch.cuda.synchronize()
    phase_profile(torch, dev, "simple_vit_b16", 256)
    phase_profile(torch, dev, "vit_b_16", 256)
    phase_profile(torch, dev, "swin_t", 128)
    phase_profile(torch, dev, "levit", 256)
    phase_profile(torch, dev, "cait", 128)
    phase_profile(torch, dev, "cvt_13", 128)
    phase_profile(torch, dev, "mobile_vit_xs", 128, image=256)
    lap("step times and profiles")

    # the packed kernels' rows, each named by the path its numbers come
    # from: the resident kernels serve SimpleViT-B/16 (N 196, (3, final))
    # and vit_b_16 (N 197, (4, no final row norm)); the scratch kernels
    # serve the float32 models, and their row takes its launches from the
    # small float32 models, its error from the float32 checks and its time
    # from float32 [256, 196, 2304] on (3, final)
    kernels = [
        kernel_entry("packed_attention_fwd float32", "packed_attention_fwd.cu",
                     "block_attention.py:234", scratch_launches["fwd"], worst["scratch"]["fwd"],
                     ktimes_f32[True]["scratch"], "fwd"),
        kernel_entry("packed_attention_bwd float32", "packed_attention_bwd.cu",
                     "block_attention.py:284", scratch_launches["bwd"], worst["scratch"]["bwd"],
                     ktimes_f32[True]["scratch"], "bwd"),
        kernel_entry("packed_resident_fwd simple_vit_b16", "packed_resident_fwd.cu",
                     "block_attention.py:234", counts["fwd"], worst[196]["fwd"],
                     ktimes[True]["resident"], "fwd"),
        kernel_entry("packed_resident_bwd simple_vit_b16", "packed_resident_bwd.cu",
                     "block_attention.py:284", counts["bwd"], worst[196]["bwd"],
                     ktimes[True]["resident"], "bwd"),
        kernel_entry("packed_resident_fwd vit_b_16", "packed_resident_fwd.cu",
                     "block_attention.py:234", counts_v["packed_resident"]["fwd"],
                     worst[197]["fwd"], ktimes_v[True]["resident"], "fwd"),
        kernel_entry("packed_resident_bwd vit_b_16", "packed_resident_bwd.cu",
                     "block_attention.py:284", counts_v["packed_resident"]["bwd"],
                     worst[197]["bwd"], ktimes_v[True]["resident"], "bwd"),
        kernel_entry("biased_attention_fwd levit_128s", "biased_attention_fwd.cu",
                     "biased_attention.py:230", counts_l["biased_shared"]["fwd"],
                     worst_b["shared"]["fwd"], btimes_levit, "fwd"),
        kernel_entry("biased_attention_bwd levit_128s", "biased_attention_bwd.cu",
                     "biased_attention.py:296", counts_l["biased_shared"]["bwd"],
                     worst_b["shared"]["bwd"], btimes_levit, "bwd"),
        kernel_entry("biased_resident_fwd swin_t", "biased_resident_fwd.cu",
                     "biased_attention.py:230", counts_b["fwd"], worst_b["resident"]["fwd"],
                     biased_row, "fwd"),
        kernel_entry("biased_resident_bwd swin_t", "biased_resident_bwd.cu",
                     "biased_attention.py:296", counts_b["bwd"], worst_b["resident"]["bwd"],
                     biased_row, "bwd"),
        kernel_entry("sinkhorn_softmax_fwd", "sinkhorn_softmax_fwd.cu", "sinkhorn_softmax.py:229",
                     counts_sq["fwd"], worst_s["square", "fwd"], stimes["square"], "fwd"),
        kernel_entry("sinkhorn_softmax_bwd", "sinkhorn_softmax_bwd.cu", "sinkhorn_softmax.py:266",
                     counts_sq["bwd"], worst_s["square", "bwd"], stimes["square"], "bwd"),
        kernel_entry("sinkhorn_softmax_rect_fwd", "sinkhorn_softmax_fwd.cu",
                     "sinkhorn_softmax.py:497", counts_l["rect"]["fwd"] + counts_c["rect"]["fwd"],
                     worst_s["rect", "fwd"], stimes["rect"], "fwd"),
        kernel_entry("sinkhorn_softmax_rect_bwd", "sinkhorn_softmax_bwd.cu",
                     "sinkhorn_softmax.py:537", counts_l["rect"]["bwd"] + counts_c["rect"]["bwd"],
                     worst_s["rect", "bwd"], stimes["rect"], "bwd"),
        kernel_entry("talking_heads_cluster_fwd cait", "talking_heads_cluster_fwd.cu",
                     "talking_heads.py:175", counts_t["talking_heads_cluster"]["fwd"],
                     worst_t["cluster"]["fwd"], ttimes["cluster"], "fwd"),
        kernel_entry("talking_heads_cluster_bwd cait", "talking_heads_cluster_bwd.cu",
                     "talking_heads.py:208", counts_t["talking_heads_cluster"]["bwd"],
                     worst_t["cluster"]["bwd"], ttimes["cluster"], "bwd"),
        kernel_entry("talking_heads_fwd 16 heads", "talking_heads_fwd.cu", "talking_heads.py:175",
                     th_plane_launches["fwd"], worst_t["plane"]["fwd"], ttimes["plane"], "fwd"),
        kernel_entry("talking_heads_bwd 16 heads", "talking_heads_bwd.cu", "talking_heads.py:208",
                     th_plane_launches["bwd"], worst_t["plane"]["bwd"], ttimes["plane"], "bwd"),
        kernel_entry("streaming_split_fwd cvt_13", "streaming_split_fwd.cu",
                     "streaming_sinkhorn.py:397", counts_c["streaming_split"]["fwd"],
                     worst_st["split"]["fwd"], sttimes["stage 1"]["split"], "fwd"),
        kernel_entry("streaming_split_bwd cvt_13", "streaming_split_bwd.cu",
                     "streaming_sinkhorn.py:449", counts_c["streaming_split"]["bwd"],
                     worst_st["split"]["bwd"], sttimes["stage 1"]["split"], "bwd"),
        kernel_entry("streaming_attention_fwd tile", "streaming_attention_fwd.cu",
                     "streaming_sinkhorn.py:397", stream_tile_launches["fwd"],
                     worst_st["tile"]["fwd"], sttimes["stage 1"]["tile"], "fwd"),
        kernel_entry("streaming_attention_bwd tile", "streaming_attention_bwd.cu",
                     "streaming_sinkhorn.py:449", stream_tile_launches["bwd"],
                     worst_st["tile"]["bwd"], sttimes["stage 1"]["tile"], "bwd"),
        kernel_entry("fused_attention_fwd float32", "fused_attention_fwd.cu",
                     "sinkhorn_attention.py:147", recompute_launches["fwd"],
                     worst_f["recompute"]["fwd"], ftimes["f32"], "fwd"),
        kernel_entry("fused_attention_bwd float32", "fused_attention_bwd.cu",
                     "sinkhorn_attention.py:694", recompute_launches["bwd"],
                     worst_f["recompute"]["bwd"], ftimes["f32"], "bwd"),
        kernel_entry("fused_resident_fwd mobile_vit_xs", "fused_resident_fwd.cu",
                     "sinkhorn_attention.py:147", counts_m["fused_resident"]["fwd"],
                     worst_f["resident"]["fwd"], fused_row, "fwd"),
        kernel_entry("fused_resident_bwd mobile_vit_xs", "fused_resident_bwd.cu",
                     "sinkhorn_attention.py:694", counts_m["fused_resident"]["bwd"],
                     worst_f["resident"]["bwd"], fused_row, "bwd"),
        kernel_entry("fused_ln_fwd", "fused_ln_fwd.cu", "fused_ln.py:90",
                     counts_s["fused_ln"]["fwd"], worst_ln["fwd"], ln_times, "fwd"),
        kernel_entry("fused_ln_bwd", "fused_ln_bwd.cu", "fused_ln.py:111",
                     counts_s["fused_ln"]["bwd"], worst_ln["bwd"], ln_times, "bwd"),
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
