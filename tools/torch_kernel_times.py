#!/usr/bin/env python3
"""Times of the port's hand-written CUDA kernels on one card: a table entry
for each measurement behind the rows of ``PERF.md`` §6's kernel table.

An entry names the kernel, its branch (``None`` where it has one), the main
path's shape, the Sinkhorn schedule (robust, iterations, final row norm), the
dtype and the baseline beside the plain PyTorch version (``sdpa``:
``scaled_dot_product_attention``; ``sdpa_dbias``: the same with the bias as a
mask whose gradient is taken; ``softmax``: ``torch.softmax``, the vanilla
model's cost; ``sandwich``: einsum, softmax, einsum; ``layer_norm``:
``F.layer_norm`` on bf16 x, weight and bias). Each is timed forward and
backward with CUDA events, beside its bound from ``benchmark/arith.py`` and
its largest error against the plain version. An entry with ``beats`` (a
redesigned branch) must be faster both ways than the entry it names; the
tool exits 1 where one is not. Prints the card's name and power limit, the
resident kernels' registers and spills (``build.ptxas_log``), a line an entry
and a ``{"kernels": [...]}`` JSON line, an element a direction. Launches per
step are ``tests/test_torch_routes.py``'s table.

    python3 tools/torch_kernel_times.py
    python3 tools/torch_kernel_times.py --only "fused_ln simple_vit_b16"
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import arith  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import fused_ln as fl  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import sinkhorn_softmax as ss  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th  # noqa: E402

ROBUST, VANILLA, VIT = (True, 3, True), (False, 3, True), (True, 4, False)
# Swin-T stage 0 at batch 128, its window count; CvT-13's streamed stages
# at batch 128 (b, h, queries, keys, d)
SWIN_T_STAGE0 = ((8192, 3, 49, 32), 64)
CVT_S1 = (128, 1, 3136, 784, 64)
CVT_S2 = (128, 3, 784, 196, 64)
# (kernel, branch) → (csrc stem, the Pallas file, its forward and backward
# kernels' lines)
SOURCES = {
    ("packed", "resident"): ("packed_resident", "block_attention.py", 234, 284),
    ("packed", "scratch"): ("packed_attention", "block_attention.py", 234, 284),
    ("fused", "resident"): ("fused_resident", "sinkhorn_attention.py", 147, 694),
    ("fused", "recompute"): ("fused_attention", "sinkhorn_attention.py", 147, 694),
    ("biased", "resident"): ("biased_resident", "biased_attention.py", 230, 296),
    ("biased", "shared"): ("biased_attention", "biased_attention.py", 230, 296),
    ("square", None): ("sinkhorn_softmax", "sinkhorn_softmax.py", 229, 266),
    ("rect", None): ("sinkhorn_softmax", "sinkhorn_softmax.py", 497, 537),
    ("talking_heads", "cluster"): ("talking_heads_cluster", "talking_heads.py", 175, 208),
    ("talking_heads", "plane"): ("talking_heads", "talking_heads.py", 175, 208),
    ("streaming", "split"): ("streaming_split", "streaming_sinkhorn.py", 397, 449),
    ("streaming", "tile"): ("streaming_attention", "streaming_sinkhorn.py", 397, 449),
    ("fused_ln", None): ("fused_ln", "fused_ln.py", 90, 111),
}


@dataclass(frozen=True)
class Entry:
    name: str
    kernel: str
    branch: str | None
    shape: tuple
    schedule: tuple | None = ROBUST
    dtype: str = "bfloat16"
    baseline: str | None = None
    beats: str | None = None

    @property
    def dt(self) -> torch.dtype:
        return getattr(torch, self.dtype)


SV, VB = (256, 196, 12, 64), (256, 197, 12, 64)
MV1, MV2, MV3 = (2048, 256, 8, 8), (2048, 64, 8, 8), (2048, 16, 8, 8)
SW0 = (*SWIN_T_STAGE0[0], 32, SWIN_T_STAGE0[1])
TABLE = [
    # row 1: packed q/k/v, SimpleViT-B/16 (3, final) and vit_b_16 (4, no final)
    Entry("packed_resident simple_vit_b16", "packed", "resident", SV,
          beats="packed_scratch simple_vit_b16 forced"),
    Entry("packed_resident simple_vit_b16 vanilla", "packed", "resident", SV, VANILLA,
          baseline="sdpa", beats="packed_scratch simple_vit_b16 forced vanilla"),
    Entry("packed_resident vit_b_16", "packed", "resident", VB, VIT,
          beats="packed_scratch vit_b_16 forced"),
    Entry("packed_resident vit_b_16 vanilla", "packed", "resident", VB, VANILLA, baseline="sdpa",
          beats="packed_scratch vit_b_16 forced vanilla"),
    Entry("packed_scratch float32", "packed", "scratch", SV, dtype="float32"),
    Entry("packed_scratch simple_vit_b16 forced", "packed", "scratch", SV),
    Entry("packed_scratch simple_vit_b16 forced vanilla", "packed", "scratch", SV, VANILLA),
    Entry("packed_scratch vit_b_16 forced", "packed", "scratch", VB, VIT),
    Entry("packed_scratch vit_b_16 forced vanilla", "packed", "scratch", VB, VANILLA),
    # row 2: fused q/k/v, MobileViT-XS's three stages (512 images × 4 heads)
    Entry("fused_resident mobile_vit_xs stage 1", "fused", "resident", MV1,
          beats="fused_recompute mobile_vit_xs stage 1 forced"),
    Entry("fused_resident mobile_vit_xs stage 1 vanilla", "fused", "resident", MV1, VANILLA,
          baseline="sdpa", beats="fused_recompute mobile_vit_xs stage 1 forced vanilla"),
    Entry("fused_resident mobile_vit_xs stage 2", "fused", "resident", MV2),
    Entry("fused_resident mobile_vit_xs stage 3", "fused", "resident", MV3),
    Entry("fused_recompute float32", "fused", "recompute", MV1, dtype="float32"),
    Entry("fused_recompute mobile_vit_xs stage 1 forced", "fused", "recompute", MV1),
    Entry("fused_recompute mobile_vit_xs stage 1 forced vanilla", "fused", "recompute", MV1,
          VANILLA),
    # row 3: biased (windowed), Swin-T stage 0 and LeViT's N = 196 stages
    Entry("biased_resident swin_t stage 0", "biased", "resident", SW0,
          beats="biased_shared swin_t stage 0 forced"),
    Entry("biased_resident swin_t stage 0 vanilla", "biased", "resident", SW0, VANILLA,
          baseline="sdpa_dbias", beats="biased_shared swin_t stage 0 forced vanilla"),
    Entry("biased_shared levit_128s stage 0", "biased", "shared", (256, 4, 196, 16, 32, 1)),
    Entry("biased_shared levit_256 stage 0", "biased", "shared", (64, 4, 196, 32, 64, 1)),
    Entry("biased_shared swin_t stage 0 forced", "biased", "shared", SW0),
    Entry("biased_shared swin_t stage 0 forced vanilla", "biased", "shared", SW0, VANILLA),
    # rows 4 and 5: the logits-interface Sinkhorn softmax, float32 logits
    Entry("sinkhorn_softmax deepvit", "square", None, (128, 8, 197, 197), dtype="float32",
          baseline="softmax"),
    Entry("sinkhorn_softmax_rect levit_128s sub0", "rect", None, (256, 8, 49, 196),
          dtype="float32", baseline="softmax"),
    Entry("sinkhorn_softmax_rect cvt_13 stage 3", "rect", None, (128, 6, 196, 49),
          dtype="float32", baseline="softmax"),
    # row 6: talking heads, CaiT's dots
    Entry("talking_heads_cluster cait", "talking_heads", "cluster", (128, 8, 196, 196),
          dtype="float32", baseline="sandwich", beats="talking_heads_plane cait forced"),
    Entry("talking_heads_plane cait forced", "talking_heads", "plane", (128, 8, 196, 196),
          dtype="float32"),
    # row 7: streaming, CvT-13's stages 1 and 2
    Entry("streaming_split cvt_13 stage 1", "streaming", "split", CVT_S1, baseline="sdpa",
          beats="streaming_tile cvt_13 stage 1 forced"),
    Entry("streaming_split cvt_13 stage 2", "streaming", "split", CVT_S2, baseline="sdpa",
          beats="streaming_tile cvt_13 stage 2 forced"),
    Entry("streaming_tile cvt_13 stage 1 forced", "streaming", "tile", CVT_S1),
    Entry("streaming_tile cvt_13 stage 2 forced", "streaming", "tile", CVT_S2),
    # row 8: the fused LayerNorm, SimpleViT-B/16's block norms (warp path) and
    # the 8-lane path at batch 128: Swin-T stage 0, CvT-13 stage 1, and
    # [100352, 192], Swin-T stage 1 and CvT-13 stage 2 alike
    Entry("fused_ln simple_vit_b16", "fused_ln", None, (50176, 768), None,
          baseline="layer_norm"),
    Entry("fused_ln swin_t stage 0", "fused_ln", None, (401408, 96), None,
          baseline="layer_norm"),
    Entry("fused_ln cvt_13 stage 1", "fused_ln", None, (401408, 64), None,
          baseline="layer_norm"),
    Entry("fused_ln swin_t stage 1", "fused_ln", None, (100352, 192), None,
          baseline="layer_norm"),
]


# the queue's hold in SM cycles: ~50 ms at the H100's 1.98 GHz, longer than
# the host takes to queue an entry's calls
HOLD_CYCLES = 100_000_000


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, between CUDA events.
    The card is held on a ~50 ms sleep kernel while the host queues the
    calls, so a kernel of a few µs reads its own time and not its
    wrapper's host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def normal(gen, shape, dtype=torch.float32, scale=1.0):
    """N(0, scale²) drawn on the generator's card, in ``dtype``."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device)).to(dtype)


def stream_inputs(gen, shape, dtype):
    """q, g [b, h, n, d] and k, v [b, h, m, d] for a streaming call."""
    b, h, n, m, d = shape
    return (normal(gen, (b, h, n, d), dtype), normal(gen, (b, h, m, d), dtype),
            normal(gen, (b, h, m, d), dtype), normal(gen, (b, h, n, d), dtype))


def autograd_pair(fn, inputs, g):
    """``fn`` forward, and its backward to every input through autograd."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return (lambda: fn(*inputs),
            lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def sdpa_pair(q, k, v, g, bias=None):
    """scaled_dot_product_attention; with ``bias`` [nW, H, N, N] as its mask,
    expanded over the images from a leaf, on the first backend that takes
    the mask's gradient."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    if bias is None:
        return autograd_pair(sdpa, (q, k, v), g)
    bw, h, n, _ = q.shape
    shape = (bw // bias.shape[0], *bias.shape)

    def masked(q, k, v, b):
        return sdpa(q, k, v, attn_mask=b.unsqueeze(0).expand(shape).reshape(bw, h, n, n))

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                fwd, bwd = autograd_pair(masked, (q, k, v, bias.to(q.dtype)), g)
                bwd()
                torch.cuda.synchronize()
        except RuntimeError:
            continue

        def fwd_under(fwd=fwd, backend=backend):
            with sdpa_kernel(backend):
                return fwd()
        return fwd_under, bwd
    raise RuntimeError("no scaled_dot_product_attention backend takes the mask's gradient")


def calls(fwd_k, bwd_k, fwd_p, bwd_p, fwd_args, bwd_args, branch, bwd_plain_kw=None):
    """The kernels of ``branch`` and the plain versions on the same arguments."""
    kw = {} if branch is None else {"branch": branch}
    return dict(fwd=lambda: fwd_k(*fwd_args, **kw), bwd=lambda: bwd_k(*bwd_args, **kw),
                plain_fwd=lambda: fwd_p(*fwd_args),
                plain_bwd=lambda: bwd_p(*bwd_args, **(bwd_plain_kw or {})))


def attention_bounds(q, k, v, vecs, schedule, extra=0, bias_add=0):
    """attention_work from the operands: q, k, v (and ``extra`` bytes, the
    bias) in, out and the residual rows out; q, k, v, the gradient, the rows
    (and the bias) in, dq, dk, dv (and dbias) out."""
    qk = (q.numel() + k.numel()) * q.element_size()
    vb, rows = v.numel() * v.element_size(), vecs.numel() * 4
    out = q.numel() // q.shape[-1] * v.shape[-1] * v.element_size()
    items = q.numel() // (q.shape[-2] * q.shape[-1])
    return arith.attention_work(items, q.shape[-2], q.shape[-1], v.shape[-1],
                                (qk + vb + extra, qk + vb + out + rows + extra),
                                (out + rows, qk + vb + extra), *schedule, bias_add,
                                m=k.shape[-2])


def packed(e, gen):
    b, n, h, d = e.shape
    qkv, g = normal(gen, (b, n, 3 * h * d), e.dt), normal(gen, (b, n, h * d), e.dt)
    args = (h, d, d ** -0.5, *e.schedule)
    vecs = pa.packed_attention_fwd_cuda(qkv, *args, branch=e.branch)[1]
    case = calls(pa.packed_attention_fwd_cuda, pa.packed_attention_bwd_cuda,
                 pa.packed_attention_fwd_plain, pa.packed_attention_bwd_plain,
                 (qkv, *args), (qkv, g, vecs, *args), e.branch)
    case["bounds"] = arith.call_bounds({"kind": "packed", "batch": b, "tokens": n, "heads": h,
                                        "dim": d}, *e.schedule, qkv.element_size())
    if e.baseline == "sdpa":
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        case["lib"] = sdpa_pair(q, k, v, g.view(b, n, h, d).transpose(1, 2).contiguous())
    return case


def fused(e, gen):
    kb, n, d, dv = e.shape
    q, k = (normal(gen, (kb, n, d), e.dt) for _ in range(2))
    v, g = normal(gen, (kb, n, dv), e.dt), normal(gen, (kb, n, dv), e.dt)
    args = (d ** -0.5, *e.schedule)
    vecs = fa.fused_attention_fwd_cuda(q, k, v, *args, branch=e.branch)[1]
    case = calls(fa.fused_attention_fwd_cuda, fa.fused_attention_bwd_cuda,
                 fa.fused_attention_fwd_plain, fa.fused_attention_bwd_plain,
                 (q, k, v, *args), (q, k, v, g, vecs, *args), e.branch)
    case["bounds"] = attention_bounds(q, k, v, vecs, e.schedule)
    if e.baseline == "sdpa":
        case["lib"] = sdpa_pair(*(x.view(kb // 4, 4, n, -1) for x in (q, k, v, g)))
    return case


def biased(e, gen):
    bw, h, n, d, dv, nw = e.shape
    q, k = (normal(gen, (bw, h, n, d), e.dt) for _ in range(2))
    v, g = (normal(gen, (bw, h, n, dv), e.dt) for _ in range(2))
    bias = normal(gen, (nw, h, n, n))
    args = (d ** -0.5, *e.schedule, nw, False)
    vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args, branch=e.branch)[1]
    case = calls(ba.biased_attention_fwd_cuda, ba.biased_attention_bwd_cuda,
                 ba.biased_attention_fwd_plain, ba.biased_attention_bwd_plain,
                 (q, k, v, bias, *args), (q, k, v, bias, g, vecs, *args), e.branch)
    case["bounds"] = attention_bounds(q, k, v, vecs, e.schedule, bias.numel() * 4, 1)
    if e.baseline == "sdpa_dbias":
        case["lib"] = sdpa_pair(q, k, v, g, bias)
    return case


def sinkhorn(e, gen):
    """The square or the rectangular kernels on float32 logits; the square
    ones' bound from their bytes and passes, the rectangular ones' from
    ``call_bounds``."""
    logits, g = normal(gen, e.shape, e.dt, 2.0), normal(gen, e.shape, e.dt)
    _, iters, final_row = e.schedule
    kind = "" if e.kernel == "square" else "_rect"
    fns = [getattr(ss, f"sinkhorn_softmax{kind}_{d}_{r}")
           for r in ("cuda", "plain") for d in ("fwd", "bwd")]
    res = fns[0](logits, iters, final_row)[1:]
    case = calls(*fns, (logits, iters, final_row), (logits, g, *res, iters, final_row), None)
    if e.kernel == "square":
        mat, rows, nn = logits.numel() * 4, sum(r.numel() for r in res) * 4, logits.numel()
        fp, bp, nt = arith.chain_passes(*e.schedule)
        case["bounds"] = (arith.bound_ms(2 * mat + rows, 0, nn * (4 + 2 * fp)),
                          arith.bound_ms(3 * mat + rows, 0, nn * (3 + 2 * bp + 4 + 2 * nt)))
    else:
        b, h, n, m = e.shape
        case["bounds"] = arith.call_bounds({"kind": "rect", "batch": b, "heads": h,
                                            "tokens": n, "keys": m}, *e.schedule)
    case["lib"] = autograd_pair(lambda x: torch.softmax(x, -1), (logits,), g)
    return case


def talking_heads(e, gen):
    """Bound from the bytes (dots, rows, both mixes) and the TPU kernel's own
    float32 estimate: B·H·N²·(4 + 4·iters + 4·H) forward, (8 + 4·iters +
    8·H) backward."""
    h = e.shape[1]
    dots, g = normal(gen, e.shape, e.dt, 2.0), normal(gen, e.shape, e.dt)
    pre, post = normal(gen, (h, h)), normal(gen, (h, h))
    _, iters, final_row = e.schedule
    vecs = th.talking_heads_fwd_cuda(dots, pre, post, iters, final_row, branch=e.branch)[1]
    case = calls(th.talking_heads_fwd_cuda, th.talking_heads_bwd_cuda,
                 th.talking_heads_fwd_plain, th.talking_heads_bwd_plain,
                 (dots, pre, post, iters, final_row),
                 (dots, g, vecs, pre, post, iters, final_row), e.branch,
                 {"strips": h if e.branch == "cluster" else None})
    mat, rows, mix, nn = dots.numel() * 4, vecs.numel() * 4, 2 * h * h * 4, dots.numel()
    case["bounds"] = (arith.bound_ms(2 * mat + rows + mix, 0, nn * (4 + 4 * iters + 4 * h)),
                      arith.bound_ms(3 * mat + rows + 2 * mix, 0, nn * (8 + 4 * iters + 8 * h)))
    if e.baseline == "sandwich":
        case["lib"] = autograd_pair(
            lambda d, p, q: torch.einsum("bhij,hg->bgij", torch.softmax(
                torch.einsum("bhij,hg->bgij", d, p), -1), q), (dots, pre, post), g)
    return case


def streaming(e, gen):
    b, h, n, m, d = e.shape
    q, k, v, g = stream_inputs(gen, e.shape, e.dt)
    args = (d ** -0.5, *e.schedule[1:])
    av, bv = sa.streaming_attention_fwd_cuda(q, k, v, *args, branch=e.branch)[1:]
    case = calls(sa.streaming_attention_fwd_cuda, sa.streaming_attention_bwd_cuda,
                 sa.streaming_attention_fwd_plain, sa.streaming_attention_bwd_plain,
                 (q, k, v, *args), (q, k, v, g, av, bv, *args), e.branch)
    case["bounds"] = arith.call_bounds({"kind": "streaming", "batch": b, "heads": h,
                                        "tokens": n, "keys": m, "dim": d}, *e.schedule,
                                       q.element_size())
    if e.baseline == "sdpa":
        case["lib"] = sdpa_pair(q, k, v, g)
    return case


def fused_ln(e, gen):
    """Bound from the bytes (x, scale, bias in, y out; x, dy, scale in, dx,
    dscale, dbias out) and ~8 and ~16 float32 operations an element."""
    rows, d = e.shape
    x = (1 + normal(gen, e.shape, torch.float32, 3.0)).to(e.dt)
    scale, bias = 1 + normal(gen, d, scale=0.2), normal(gen, d, scale=0.1)
    dy = normal(gen, e.shape, e.dt)
    case = calls(fl.fused_ln_fwd_cuda, fl.fused_ln_bwd_cuda, fl.fused_ln_fwd_plain,
                 fl.fused_ln_bwd_plain, (x, scale, bias), (x, scale, dy), None)
    act, vec, el = x.numel() * x.element_size(), d * 4, x.numel()
    case["bounds"] = (arith.bound_ms(2 * act + 2 * vec, 0, 8 * el),
                      arith.bound_ms(3 * act + 3 * vec, 0, 16 * el))
    case["lib"] = autograd_pair(lambda x, w, b: torch.nn.functional.layer_norm(
        x, (d,), w, b, 1e-5), (x, scale.to(e.dt), bias.to(e.dt)), dy)
    return case


FAMILIES = {"packed": packed, "fused": fused, "biased": biased, "square": sinkhorn,
            "rect": sinkhorn, "talking_heads": talking_heads, "streaming": streaming,
            "fused_ln": fused_ln}


def max_err(got, want) -> float:
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want) if a is not None)


def time_entry(e: Entry, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    case = FAMILIES[e.kernel](e, gen)
    out = {}
    for dn, bound in zip(("fwd", "bwd"), case["bounds"]):
        kernel, plain = case[dn], case[f"plain_{dn}"]
        got, want = kernel(), plain()
        if dn == "fwd":  # the output, not the residual rows
            got, want = (x[0] if isinstance(x, tuple) else x for x in (got, want))
        err = max_err(got, want)
        lib = case.get("lib")
        out[dn] = {"ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5),
                   "library_ms": cuda_ms(lib[dn == "bwd"], 20) if lib else None,
                   "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err}
    del case
    torch.cuda.empty_cache()
    return out


def ptxas_report(lib_path) -> None:
    """The resident kernels' registers, stack and spills from the build's
    -Xptxas -v report."""
    resident = {f"{stem}_{dn}.cu" for (_, branch), (stem, *_) in SOURCES.items()
                if branch == "resident" for dn in ("fwd", "bwd")}
    section = None
    for line in build.ptxas_log(lib_path).read_text().splitlines():
        if line.startswith("== "):
            section = line[3:]
        elif section in resident and any(
                w in line for w in ("registers", "spill", "stack frame")):
            print(f"build: ptxas {section}: {line.strip()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", metavar="NAME",
                    help="time only this entry (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(args.only or ()) - {e.name for e in TABLE}
    if unknown:
        print(f"torch_kernel_times: no entry {sorted(unknown)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}", flush=True)
    ptxas_report(lib_path)
    times, kernels = {}, []
    for seed, e in enumerate(TABLE):
        if args.only and e.name not in args.only:
            continue
        t = times[e.name] = time_entry(e, seed)
        sched = (f" robust={int(e.schedule[0])} iters={e.schedule[1]} "
                 f"final_row={int(e.schedule[2])}" if e.schedule else "")
        print(f"{e.name}: {e.dtype} {list(e.shape)}{sched} ms: "
              + "; ".join(f"{dn} {t[dn]['ms']:.4f} (plain {t[dn]['plain_ms']:.4f}, bound "
                          f"{t[dn]['bound_ms']:.4f} {t[dn]['bound_by']}"
                          + (f", {e.baseline} {t[dn]['library_ms']:.4f}" if e.baseline else "")
                          + f", max err {t[dn]['max_abs_err']:.3g})" for dn in ("fwd", "bwd")),
              flush=True)
        stem, pallas, *lines = SOURCES[e.kernel, e.branch]
        for dn, line in zip(("fwd", "bwd"), lines):
            kernels.append({"name": f"{e.name} {dn}", "route": "cuda",
                            "source": f"noise_robust_vit_tpu_torch/ops/cuda/csrc/{stem}_{dn}.cu",
                            "replaces": f"noise_robust_vit_tpu/ops/pallas/{pallas}:{line}",
                            **t[dn]})
    slower = [f"{e.name} against {e.beats}" for e in TABLE
              if e.beats and e.name in times and e.beats in times
              and not all(times[e.name][dn]["ms"] < times[e.beats][dn]["ms"]
                          for dn in ("fwd", "bwd"))]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    if slower:
        print(f"torch_kernel_times: not faster: {slower}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
