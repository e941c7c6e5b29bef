#!/usr/bin/env python3
"""Where the time of the resident biased (windowed) kernels goes, on one CUDA GPU.

Copies the package's kernel sources to ``build/biased_phases/csrc`` with
``clock64()`` timers behind the ``BRES_PHASE`` markers of
``biased_resident_{fwd,bwd}.cu`` (each marker a barrier of the item's warps;
the item's first thread adds the cycles since the previous marker to the
phase's global sum), builds that copy into its own library, and runs the
kernels at Swin-T's stage 0 ``[8192, 3, 49, 32]`` bf16 with 64 windows (or
the shapes given), vanilla and robust (3, final). Prints the kernels' times
(the markers' barriers cost a little) and the cycles an item (one image of
one (window, head) unit) spends in each phase, beside the card's name and
power limit.

Forward phases: load (the wait for the image's q, k, v tiles, and at a
unit's first image its bias row), q·kᵀ + bias + softmax, the Sinkhorn
chain, the output product. Backward phases: load (q, k, v, g and the
residual rows), A = exp(q·kᵀ + bias − lse), da, t1 (dV, db, the last dc),
the reverse chain, dS (with the rank-1 terms, added into the unit's
dbias), dQ and dK, the unit's dbias partial.

    python3 tools/torch_biased_phases.py                     # Swin-T stage 0
    python3 tools/torch_biased_phases.py 256x8x16x16x32x1    # BWxHxNxDxDVxnW
    python3 tools/torch_biased_phases.py --csrc build/old/csrc  # other sources
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import biased_attention as ba  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402

SLOTS = 16
TIMERS = '''
static __device__ unsigned long long g_bres_phase[%d];
#define BRES_PHASE_INIT unsigned long long ph_last = clock64();
#define BRES_PHASE(k) do { slot_sync<NC>(p, S); if (p.strip == 0 && p.lane == 0) { \\
  unsigned long long now = clock64(); atomicAdd(&g_bres_phase[(k)], now - ph_last); \\
  ph_last = now; } } while (0)
''' % SLOTS
READER = '''
extern "C" int %s(unsigned long long* out) {
  static unsigned long long zero[%d];
  cudaMemcpyFromSymbol(out, g_bres_phase, sizeof(zero));
  cudaMemcpyToSymbol(g_bres_phase, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
'''
PHASES = {"fwd": ["load", "q·kᵀ + bias + softmax", "chain", "output"],
          "bwd": ["load", "A = exp", "da", "t1, dV, dc", "reverse chain", "dS + dbias acc",
                  "dQ + dK", "dbias partial"]}
SWIN_T_STAGE_0 = (8192, 3, 49, 32, 32, 64)


def instrumented_library(src: Path = build.CSRC, name: str = "biased_phases") -> ctypes.CDLL:
    """The library of the sources in ``src`` with the timers, built under
    ``build/<name>``."""
    root = Path(__file__).resolve().parents[1] / "build" / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(src, csrc)
    for direction in ("fwd", "bwd"):
        path = csrc / f"biased_resident_{direction}.cu"
        text = path.read_text()
        anchor = '#include "biased_resident.cuh"'
        if anchor not in text:
            raise RuntimeError(f"{path.name}: no include line to put the timers before")
        text = text.replace(anchor, TIMERS + anchor, 1)
        path.write_text(text + READER % (f"nrv_bres_phases_{direction}", SLOTS))
    lib = build.open_library(build.build(csrc, root))
    for direction in ("fwd", "bwd"):
        fn = getattr(lib, f"nrv_bres_phases_{direction}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def read_phases(lib, direction):
    out = (ctypes.c_ulonglong * SLOTS)()
    if getattr(lib, f"nrv_bres_phases_{direction}")(ctypes.addressof(out)) != 0:
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


def main(shapes, src: Path = build.CSRC) -> int:
    if not torch.cuda.is_available():
        print("torch_biased_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}")
    lib = instrumented_library(src)
    build.load_library = lambda: lib  # the wrappers launch the instrumented copy
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for bw, h, n, d, dv, nw in shapes:
        if ba.biased_branch(n, d, dv, torch.bfloat16) != "resident":
            raise ValueError(f"[{bw},{h},{n},{d}] DV={dv}: not a resident shape")
        q, k = (torch.randn(bw, h, n, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        v, g = (torch.randn(bw, h, n, dv, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias = torch.randn(nw, h, n, n, generator=gen, device=dev)
        items = bw * h
        for robust in (False, True):
            args = (d ** -0.5, robust, 3, True, nw, False)
            _, vecs = ba.biased_attention_fwd_cuda(q, k, v, bias, *args)
            runs = {"fwd": lambda: ba.biased_attention_fwd_cuda(q, k, v, bias, *args),
                    "bwd": lambda: ba.biased_attention_bwd_cuda(q, k, v, bias, g, vecs, *args)}
            for direction, fn in runs.items():
                ms = cuda_ms(fn)
                read_phases(lib, direction)
                fn()
                cycles = read_phases(lib, direction)
                names = PHASES[direction]
                per_item = [c / items for c in cycles[:len(names)]]
                chunks, per = ba._res_walk(q, v, nw, robust, 3, direction == "bwd")
                print(f"[{bw},{h},{n},{d}] DV={dv} nW={nw} "
                      f"{'robust (3, final)' if robust else 'vanilla'} {direction}: {ms:.4f} ms, "
                      f"{chunks} chunks of {per} images, cycles an item "
                      f"{sum(per_item):.0f}: "
                      + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(names, per_item)))
    print(f"device: {card}")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    src = build.CSRC
    if args[:1] == ["--csrc"]:
        src, args = Path(args[1]).resolve(), args[2:]
    sys.exit(main([tuple(int(x) for x in a.split("x")) for a in args] or [SWIN_T_STAGE_0], src))
