#!/usr/bin/env python3
"""Where the time of the resident fused q/k/v kernels goes, on one CUDA GPU.

Copies the package's kernel sources to ``build/fused_phases/csrc`` with
``clock64()`` timers behind the ``FRES_PHASE`` markers of
``fused_resident_{fwd,bwd}.cu`` (each marker a block barrier; thread 0 of
every block adds the cycles since the previous marker to the phase's
global sum), builds that copy into its own library, and runs the kernels
at MobileViT-XS's stage shapes ``[2048, 256 | 64 | 16, 8]`` bf16, vanilla
and robust (3, final). Prints the kernels' times (the barriers cost a
little) and the cycles a block spends in each phase, averaged over the
launch's blocks, beside the card's name and power limit.

Forward phases: load (q, k, v by cp.async), q·kᵀ and the softmax, the
Sinkhorn chain, the output product. Backward phases: load (q, k, v, g and
the vectors), A = exp(q·kᵀ − lse), da, t1 (dV, db, the last dc),
the reverse chain, dS, dQ and dK.

    python3 tools/torch_fused_phases.py            # stage 1
    python3 tools/torch_fused_phases.py 256 64 16  # the three stages
    python3 tools/torch_fused_phases.py --csrc build/old/csrc 256  # other sources
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import fused_attention as fa  # noqa: E402

SLOTS = 16
TIMERS = '''
static __device__ unsigned long long g_fres_phase[%d];
#define FRES_PHASE_INIT unsigned long long ph_last = clock64();
#define FRES_PHASE(k) do { __syncthreads(); if (threadIdx.x == 0) { \\
  unsigned long long now = clock64(); atomicAdd(&g_fres_phase[(k)], now - ph_last); \\
  ph_last = now; } } while (0)
''' % SLOTS
READER = '''
extern "C" int %s(unsigned long long* out) {
  static unsigned long long zero[%d];
  cudaMemcpyFromSymbol(out, g_fres_phase, sizeof(zero));
  cudaMemcpyToSymbol(g_fres_phase, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
'''
PHASES = {"fwd": ["load", "q·kᵀ + softmax", "chain", "output"],
          "bwd": ["load", "A = exp", "da", "t1, dV, dc", "reverse chain", "dS",
                  "dQ + dK"]}


def instrumented_library(src: Path = build.CSRC, name: str = "fused_phases") -> ctypes.CDLL:
    """The library of the sources in ``src`` with the timers, built under
    ``build/<name>``."""
    root = Path(__file__).resolve().parents[1] / "build" / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(src, csrc)
    for direction in ("fwd", "bwd"):
        path = csrc / f"fused_resident_{direction}.cu"
        text = path.read_text()
        anchor = '#include "fused_resident.cuh"'
        if anchor not in text:
            raise RuntimeError(f"{path.name}: no include line to put the timers before")
        text = text.replace(anchor, TIMERS + anchor, 1)
        path.write_text(text + READER % (f"nrv_fres_phases_{direction}", SLOTS))
    lib = build.open_library(build.build(csrc, root))
    for direction in ("fwd", "bwd"):
        fn = getattr(lib, f"nrv_fres_phases_{direction}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def read_phases(lib, direction):
    out = (ctypes.c_ulonglong * SLOTS)()
    if getattr(lib, f"nrv_fres_phases_{direction}")(ctypes.addressof(out)) != 0:
        raise RuntimeError("reading the phase timers failed")
    return list(out)


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(ns, src: Path = build.CSRC) -> int:
    if not torch.cuda.is_available():
        print("torch_fused_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}")
    lib = instrumented_library(src)
    build.load_library = lambda: lib  # the wrappers launch the instrumented copy
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in ns:
        kb = 2048
        q, k, v, g = (torch.randn(kb, n, 8, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        blocks = -(-kb // fa._res_items(n)) * (2 if n > fa._RES_ROWS else 1)
        for robust in (False, True):
            _, vecs = fa.fused_attention_fwd_cuda(q, k, v, 8 ** -0.5, robust)
            runs = {"fwd": lambda: fa.fused_attention_fwd_cuda(q, k, v, 8 ** -0.5, robust),
                    "bwd": lambda: fa.fused_attention_bwd_cuda(q, k, v, g, vecs, 8 ** -0.5,
                                                               robust)}
            for direction, fn in runs.items():
                ms = cuda_ms(fn)
                read_phases(lib, direction)
                fn()
                cycles = read_phases(lib, direction)
                names = PHASES[direction]
                per_block = [c / blocks for c in cycles[:len(names)]]
                print(f"[{kb},{n},8] {'robust (3, final)' if robust else 'vanilla'} {direction}: "
                      f"{ms:.4f} ms, {blocks} blocks of {fa._res_items(n)} item(s), cycles a "
                      f"block {sum(per_block):.0f}: "
                      + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(names, per_block)))
    print(f"device: {card}")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    src = build.CSRC
    if args[:1] == ["--csrc"]:
        src, args = Path(args[1]).resolve(), args[2:]
    sys.exit(main([int(a) for a in args] or [256], src))
