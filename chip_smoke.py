#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: builds the hand-written
kernels, holds them against their plain PyTorch versions, takes a few
SimpleViT-B/16 @224 bf16 train steps through them, and times kernels and
steps.

    python3 chip_smoke.py     # all phases; ~2 minutes on an H100

Phases, one line each (or a few):
  1. device   the card's name and power limit, as nvidia-smi reports them;
              exits non-zero without a CUDA device
  2. build    nvcc build of noise_robust_vit_tpu_torch/ops/cuda/csrc, seconds
  3. kernels  forward and backward kernels against the plain versions at
              [8, 196|197, 2304] (H=12, D=64), vanilla and three Sinkhorn
              schedules, and at the main path's [256, 196, 2304], vanilla and
              robust (3, final), where each block of the grid takes about 12
              heads in turn; in float32 (atol 1e-4, rtol 1e-3: the sums run
              in another order and the reverse chain amplifies it) and
              bfloat16 (atol 2e-2: one bf16 rounding of values of order one)
  4. slice    a small SimpleViT, kernels against the plain path; then 5 AdamW
              steps (lr 1e-4, wd 0.05) of SimpleViT-B/16 bf16 on one fixed
              batch of 64, robust and vanilla: finite, falling loss, and 12
              launches per step of each kernel
  5. timing   kernels against plain versions at [256, 196, 2304], and the
              train step at batch 256 (median of 3 windows, AdamW lr 1e-3):
              img/s and MFU against 989 TFLOP/s dense bf16
  6. profile  device time by op and kernel over one robust train step at
              batch 256 (torch.profiler), the top 30 rows
Then the card line again, a {"kernels": [...]} JSON line, and as the last
line {"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero without printing the last line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
MODES = [(False, 3, True), (True, 3, True), (True, 4, False), (True, 4, True)]
FWD_SRC = "noise_robust_vit_tpu_torch/ops/cuda/csrc/packed_attention_fwd.cu"
BWD_SRC = "noise_robust_vit_tpu_torch/ops/cuda/csrc/packed_attention_bwd.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def vit_train_flops_per_image(image=224, patch=16, dim=768, depth=12, heads=12,
                              mlp=3072, classes=1000):
    """bench.py's analytic train FLOPs per image (bwd ≈ 2× fwd)."""
    n = (image // patch) ** 2
    per_block = (
        2 * n * dim * (3 * dim)      # qkv proj
        + 2 * n * n * dim            # q@k^T
        + 2 * n * n * dim            # attn@v
        + 2 * n * dim * dim          # out proj
        + 2 * n * dim * mlp * 2      # mlp fc1+fc2
    )
    fwd = n * 2 * (patch * patch * 3) * dim + depth * per_block + 2 * dim * classes
    return 3 * fwd


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
    """Kernel against plain version: every mode at [8, 196|197, 2304], and
    vanilla and robust (3, final) at the main path's [256, 196, 2304], where
    the grid has fewer blocks than heads and each block takes about 12 heads
    in turn, reusing its scratch slot and shared vectors. Returns the
    largest bfloat16 errors at the main path's shape (fwd out, bwd dqkv)."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(0)
    h, d = 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, N, dtypes, modes)
    groups = [(8, 196, (f32, bf16), MODES), (8, 197, (f32,), MODES),
              (256, 196, (f32, bf16), MODES[:2])]
    for b, n, dtypes, modes in groups:
        qkv32 = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d), dtype=np.float32)).to(dev)
        g32 = torch.from_numpy(rng.standard_normal((b, n, h * d), dtype=np.float32)).to(dev)
        kb = b * h
        per_block = math.ceil(kb / pa._n_slots(dev, kb))
        for dtype in dtypes:
            qkv, g = qkv32.to(dtype), g32.to(dtype)
            for robust, iters, final_row in modes:
                args = (h, d, d ** -0.5, robust, iters, final_row)
                out_k, vecs_k = pa.packed_attention_fwd_cuda(qkv, *args)
                dq_k = pa.packed_attention_bwd_cuda(qkv, g, vecs_k, *args)
                torch.cuda.synchronize()
                out_p, vecs_p = pa.packed_attention_fwd_plain(qkv, *args)
                dq_p = pa.packed_attention_bwd_plain(qkv, g, vecs_p, *args)
                torch.cuda.synchronize()
                e_out = (out_k.float() - out_p.float()).abs().max().item()
                e_vec = (vecs_k - vecs_p).abs().max().item()
                e_dq = (dq_k.float() - dq_p.float()).abs().max().item()
                log(f"kernels: {str(dtype).split('.')[1]} [{b},{n},{3 * h * d}] "
                    f"robust={int(robust)} iters={iters} final_row={int(final_row)} "
                    f"heads/block<={per_block} max_abs_err out={e_out:.3g} "
                    f"vecs={e_vec:.3g} dqkv={e_dq:.3g}")
                if dtype == f32:
                    torch.testing.assert_close(out_k, out_p, atol=1e-4, rtol=1e-3)
                    torch.testing.assert_close(vecs_k, vecs_p, atol=1e-4, rtol=1e-3)
                    torch.testing.assert_close(dq_k, dq_p, atol=1e-4, rtol=1e-3)
                else:
                    torch.testing.assert_close(out_k.float(), out_p.float(), atol=2e-2, rtol=0)
                    torch.testing.assert_close(vecs_k, vecs_p, atol=1e-3, rtol=1e-3)
                    torch.testing.assert_close(dq_k.float(), dq_p.float(), atol=2e-2, rtol=2e-2)
                    if b == 256:
                        worst["fwd"] = max(worst["fwd"], e_out)
                        worst["bwd"] = max(worst["bwd"], e_dq)
                del out_k, vecs_k, dq_k, out_p, vecs_p, dq_p
        del qkv32, g32, qkv, g
    torch.cuda.empty_cache()
    return worst


def phase_small_model(torch, dev):
    """The model wiring through the kernels: a small float32 SimpleViT on the
    card (kernels) against the same weights on the CPU (plain versions)."""
    from noise_robust_vit_tpu_torch import create_model

    kw = dict(num_classes=10, image_size=64, robust=True, dim=128, depth=2,
              heads=2, mlp_dim=256, dim_head=64)
    cpu = create_model("simple_vit", **kw)
    gpu = create_model("simple_vit", device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4))
    outs = []
    for model, xx, yy in ((cpu, x, y), (gpu, x.to(dev), y.to(dev))):
        logits = model(xx)
        torch.nn.functional.cross_entropy(logits.float(), yy).backward()
        outs.append((logits.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-3)
    err = max((outs[1][1][k] - g).abs().max().item() for k, g in outs[0][1].items())
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, atol=1e-4, rtol=1e-3, msg=k)
    log(f"slice: small SimpleViT f32 card vs cpu: logits and grads agree "
        f"(max grad err {err:.3g})")


def phase_train(pa, torch, dev, steps=5, batch=64):
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((batch, 224, 224, 3), dtype=np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    counts = {"fwd": 0, "bwd": 0}
    for robust in (True, False):
        model = create_model("simple_vit_b16", num_classes=1000, image_size=224,
                             robust=robust, dtype=torch.bfloat16, device=dev, seed=0)
        state = create_train_state(model, lr=1e-4, weight_decay=0.05)
        pa.launches.reset()
        losses = [float(state.train_step(x, y)) for _ in range(steps)]
        torch.cuda.synchronize()
        fwd, bwd = pa.launches.fwd, pa.launches.bwd
        log(f"slice: simple_vit_b16 bf16 robust={int(robust)} batch={batch} "
            f"losses={[round(v, 5) for v in losses]} launches fwd={fwd} bwd={bwd}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not fall: {losses}")
        if fwd != 12 * steps or bwd != 12 * steps:
            raise RuntimeError(f"expected {12 * steps} launches of each kernel, "
                               f"got fwd={fwd} bwd={bwd}")
        counts["fwd"] += fwd
        counts["bwd"] += bwd
        del model, state
    return counts


def phase_kernel_times(pa, torch, dev, b=256, n=196, h=12, d=64):
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d), dtype=np.float32)).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((b, n, h * d), dtype=np.float32)).to(dev, torch.bfloat16)
    times = {}
    for robust in (True, False):
        args = (h, d, d ** -0.5, robust, 3, True)
        _, vecs = pa.packed_attention_fwd_cuda(qkv, *args)
        t = {
            "fwd": cuda_ms(lambda: pa.packed_attention_fwd_cuda(qkv, *args), 10),
            "fwd_plain": cuda_ms(lambda: pa.packed_attention_fwd_plain(qkv, *args), 10),
            "bwd": cuda_ms(lambda: pa.packed_attention_bwd_cuda(qkv, g, vecs, *args), 10),
            "bwd_plain": cuda_ms(lambda: pa.packed_attention_bwd_plain(qkv, g, vecs, *args), 10),
        }
        times[robust] = t
        log(f"timing: packed attention bf16 [{b},{n},{3 * h * d}] robust={int(robust)} "
            f"(3, final) ms: fwd {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}) "
            f"bwd {t['bwd']:.4f} (plain {t['bwd_plain']:.4f})")
    return times


def phase_step_times(torch, dev, batch=256, steps=10, windows=3):
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    flops = vit_train_flops_per_image()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((batch, 224, 224, 3), dtype=np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    result = {}
    for robust in (False, True):
        model = create_model("simple_vit_b16", num_classes=1000, image_size=224,
                             robust=robust, dtype=torch.bfloat16, device=dev, seed=0)
        state = create_train_state(model, lr=1e-3, weight_decay=0.05)
        torch.cuda.reset_peak_memory_stats(dev)
        float(state.train_step(x, y))  # warm-up
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = state.train_step(x, y)
            loss = float(loss)
            rates.append(batch * steps / (time.perf_counter() - t0))
        rate = statistics.median(rates)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        result[robust] = rate
        log(f"timing: train step simple_vit_b16 bf16 batch={batch} robust={int(robust)}: "
            f"{rate:.2f} img/s (windows {[round(r, 2) for r in rates]}), "
            f"{1e3 * batch / rate:.2f} ms/step, MFU {rate * flops / PEAK_BF16:.4f}, "
            f"peak mem {peak:.2f} GiB, loss {loss:.4f}")
        del model, state
    return result


def phase_profile(torch, dev, batch=256):
    """Device time by op and kernel over one robust train step."""
    from torch.profiler import ProfilerActivity, profile

    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((batch, 224, 224, 3), dtype=np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    model = create_model("simple_vit_b16", num_classes=1000, image_size=224,
                         robust=True, dtype=torch.bfloat16, device=dev, seed=0)
    state = create_train_state(model)
    for _ in range(2):
        state.train_step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state.train_step(x, y)
        torch.cuda.synchronize()
    log("profile: robust train step, batch 256, top rows by device time")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from noise_robust_vit_tpu_torch.ops.cuda import build
    from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    worst = phase_kernels(pa, torch, dev)
    torch.cuda.synchronize()
    phase_small_model(torch, dev)
    torch.cuda.synchronize()
    counts = phase_train(pa, torch, dev)
    torch.cuda.synchronize()
    ktimes = phase_kernel_times(pa, torch, dev)
    torch.cuda.synchronize()
    phase_step_times(torch, dev)
    torch.cuda.synchronize()
    phase_profile(torch, dev)

    kernels = [
        {"name": "packed_attention_fwd", "route": "cuda", "source": FWD_SRC,
         "replaces": "noise_robust_vit_tpu/ops/pallas/block_attention.py:234",
         "launches": counts["fwd"], "max_abs_err": worst["fwd"],
         "ms": ktimes[True]["fwd"], "plain_ms": ktimes[True]["fwd_plain"]},
        {"name": "packed_attention_bwd", "route": "cuda", "source": BWD_SRC,
         "replaces": "noise_robust_vit_tpu/ops/pallas/block_attention.py:284",
         "launches": counts["bwd"], "max_abs_err": worst["bwd"],
         "ms": ktimes[True]["bwd"], "plain_ms": ktimes[True]["bwd_plain"]},
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
