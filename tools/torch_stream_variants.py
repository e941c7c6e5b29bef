#!/usr/bin/env python3
"""Versions of the port's streaming attention kernels side by side, on one
CUDA GPU.

Each argument is a directory of kernel sources (the package's
``ops/cuda/csrc`` by default; e.g. a parent commit's, unpacked under
``build/``). Each is built into its own library under ``build/variants/``,
checked against the plain versions at CvT-13's stage 1 and stage 2 q/k/v
(batch 128, bf16, (3, final): out, dq, dk, dv to 2e-2, the residual vectors
to 1e-3; a variant that fails to build or to agree is reported and not
timed), and its forward
and backward timed there, the builds in turns (a, b, …, b, a), beside the
card's name and power limit. ``--branch split`` or ``--branch tile``
forces one branch of the kernels (by default each call takes the branch
the rule picks: split at these shapes); every directory must then hold
that branch's sources.

    python3 tools/torch_stream_variants.py build/v1/csrc noise_robust_vit_tpu_torch/ops/cuda/csrc
    python3 tools/torch_stream_variants.py --branch split build/v1/csrc build/v2/csrc
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch_kernel_times import CVT_S1, CVT_S2, card_line, cuda_ms, stream_inputs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import streaming_attention as sa  # noqa: E402


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    parser = argparse.ArgumentParser()
    parser.add_argument("--branch", choices=("split", "tile"), default=None)
    parser.add_argument("dirs", nargs="*")
    args = parser.parse_args(argv)
    branch = args.branch
    dirs = args.dirs or [str(build.CSRC)]
    t0 = time.perf_counter()
    libs = {}
    for i, d in enumerate(dirs):
        try:
            libs[d] = build.open_library(build.build(Path(d), Path("build/variants") / f"v{i}"))
        except (RuntimeError, AttributeError) as err:  # not built, or an entry missing
            print(f"build: {d} failed: {str(err)[-3000:]}", flush=True)
    dirs = [d for d in dirs if d in libs]
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(dirs)} source director"
          f"{'y' if len(dirs) == 1 else 'ies'}", flush=True)
    if not dirs:
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, shape in (("stage 1", CVT_S1), ("stage 2", CVT_S2)):
        q, k, v, g = stream_inputs(gen, shape, torch.bfloat16)
        scale = shape[-1] ** -0.5
        want = sa.streaming_attention_fwd_plain(q, k, v, scale)
        want = (*want, *sa.streaming_attention_bwd_plain(q, k, v, g, *want[1:], scale))
        for d in dirs + dirs[::-1]:
            build.load_library = (lambda lib: (lambda: lib))(libs[d])
            got = sa.streaming_attention_fwd_cuda(q, k, v, scale, branch=branch)
            got = (*got, *sa.streaming_attention_bwd_cuda(q, k, v, g, *got[1:], scale,
                                                          branch=branch))
            torch.cuda.synchronize()
            try:
                for i, (a, b) in enumerate(zip(got, want)):
                    tol = 1e-3 if i in (1, 2) else 2e-2
                    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                               msg=f"{d}: output {i}")
            except AssertionError as err:  # a broken variant is reported, not timed
                print(f"{label} {list(shape)} {d}: check failed: {err}", flush=True)
                continue
            av, bv = got[1:3]
            fwd = cuda_ms(
                lambda: sa.streaming_attention_fwd_cuda(q, k, v, scale, branch=branch), 10)
            bwd = cuda_ms(
                lambda: sa.streaming_attention_bwd_cuda(q, k, v, g, av, bv, scale,
                                                        branch=branch), 10)
            print(f"{label} {list(shape)} {d}: fwd {fwd:.4f} ms bwd {bwd:.4f} ms", flush=True)
        del q, k, v, g, want, got
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
