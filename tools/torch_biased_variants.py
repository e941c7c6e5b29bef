#!/usr/bin/env python3
"""Variants of the port's biased attention kernels side by side, on one
CUDA GPU.

A variant is ``F/B`` (the minimum blocks per SM in the forward and the
backward kernel's ``__launch_bounds__``) or ``F/B@DIR`` (the same, built from
the kernel sources in DIR instead of ``ops/cuda/csrc``, e.g. a parent
commit's). Each is built from a copy under ``build/variants/``; the script
prints ptxas' registers and spills of the bf16 kernels, checks each build
against the plain versions and times the forward and the backward at
Swin-T stage 0 ([8192, 3, 49, 32], nW=64, bf16), robust (3, final) and
vanilla, with the builds in turns (a, b, …, b, a).

    python3 tools/torch_biased_variants.py             # 2/2 3/3 4/4 4/3
    python3 tools/torch_biased_variants.py 4/3@old/csrc 4/3
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch_kernel_times import SWIN_T_STAGE0, card_line, cuda_ms

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402

BOUND = re.compile(r"__launch_bounds__\(kThreads, \d+\)")


def build_variant(spec: str):
    blocks, _, root = spec.partition("@")
    fwd, bwd = map(int, blocks.split("/"))
    src = Path("build/variants") / re.sub(r"\W", "_", spec)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(root or build.CSRC, src)
    for name, blocks in (("biased_attention_fwd.cu", fwd), ("biased_attention_bwd.cu", bwd)):
        path = src / name
        path.write_text(BOUND.sub(f"__launch_bounds__(kThreads, {blocks})", path.read_text()))
    out = src.parent / f"lib_{fwd}_{bwd}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(out),
           *map(str, sorted(src.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "biased_attention" in line and "bfloat16" in line:
            kernel = "fwd" if "fwd_kernel" in line else "bwd"
            print(f"{spec} {kernel}: {lines[i + 2].strip()} | {lines[i + 3].strip()}")
    return build.open_library(out)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    specs = argv or ["2/2", "3/3", "4/4", "4/3"]
    libs = {spec: build_variant(spec) for spec in specs}
    dev = torch.device("cuda")
    (bw, h, n, d), nw = SWIN_T_STAGE0
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bw, h, n, d), dtype=np.float32))
                  .to(dev, torch.bfloat16) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((nw, h, n, n), dtype=np.float32)).to(dev)
    for robust in (True, False):
        args = (d ** -0.5, robust, 3, True, nw, False)
        out_p, vecs_p = ba.biased_attention_fwd_plain(q, k, v, bias, *args)
        want = (out_p, *ba.biased_attention_bwd_plain(q, k, v, bias, g, vecs_p, *args))
        for spec in specs + specs[::-1]:
            build.load_library = (lambda lib: (lambda: lib))(libs[spec])
            out, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
            got = (out, *ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args))
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            if err > 2e-2:
                raise RuntimeError(f"{spec}: kernel disagrees with the plain version ({err})")
            fwd = cuda_ms(lambda: ba.biased_attention_fwd_cuda(q, k, v, bias, *args), 20)
            bwd = cuda_ms(
                lambda: ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args), 20)
            print(f"robust={int(robust)} {spec}: "
                  f"fwd {fwd:.4f} ms bwd {bwd:.4f} ms max err {err:.3g}", flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
