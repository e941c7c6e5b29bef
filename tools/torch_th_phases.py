#!/usr/bin/env python3
"""Where the time of the talking-heads cluster kernels goes, on one CUDA GPU;
and versions of them side by side.

For each directory of kernel sources (the package's ``csrc`` by default),
copies its headers and ``talking_heads_cluster_{fwd,bwd}.cu`` to
``build/th_phases/<i>/`` twice and builds each copy into its own small
library: one as it is, one with ``clock64()`` timers behind the
``THC_PHASE`` markers (each marker a block barrier; thread 0 of every block
adds the cycles since the previous marker to the phase's global sum). Then,
at CaiT's dots ``[128, 8, 196, 196]`` float32, robust (3, final) unless
given other arguments: every version against the plain version (out and
d dots, as ``tests/test_torch_talking_heads.py`` holds them), its forward and backward times in
turns (versions in order, then in reverse, the mean of the two), and the
cycles a block spends in each phase, averaged over the launch's blocks,
beside the card's name and power limit.

Forward phases: set-up, premix (the strip's loads, the mixes and the
sends), wait for the plane, softmax with the first column sums, the other
iterations, the final row norm and w, the cluster barrier, post-mix (strip
k of every w, the output), the last cluster barrier. Backward: set-up, the
strip's A, gw and sums, the da and db sends with the dpost sum, wait for
the plane, db and the final row norm's column pass, the fused reverse
passes, the last pass (C), the cluster barrier, the strip's dm and ds,
the dpre sum, the last cluster barrier.

    python3 tools/torch_th_phases.py
    python3 tools/torch_th_phases.py --csrc build/old/csrc \
        --csrc noise_robust_vit_tpu_torch/ops/cuda/csrc
    python3 tools/torch_th_phases.py --shape 128x8x196x196 --iters 4 --no-final
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import talking_heads as th  # noqa: E402

SLOTS = 16
SOURCES = ("talking_heads_cluster_fwd.cu", "talking_heads_cluster_bwd.cu")
TIMERS = '''
static __device__ unsigned long long g_thc_phase[%d];
#define THC_PHASE_INIT unsigned long long ph_last = clock64();
#define THC_PHASE(k) do { __syncthreads(); if (threadIdx.x == 0) { \\
  unsigned long long now = clock64(); atomicAdd(&g_thc_phase[(k)], now - ph_last); \\
  ph_last = now; } } while (0)
''' % SLOTS
READER = '''
extern "C" int %s(unsigned long long* out) {
  static unsigned long long zero[%d];
  cudaMemcpyFromSymbol(out, g_thc_phase, sizeof(zero));
  cudaMemcpyToSymbol(g_thc_phase, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
'''
PHASES = {"fwd": ["set-up", "premix", "wait", "softmax", "iterations", "final + w",
                  "cluster barrier", "post-mix", "exit barrier"],
          "bwd": ["set-up", "strip sums", "sends + dpost", "wait", "db + final col",
                  "reverse passes", "last pass (C)", "cluster barrier", "strip dm, ds",
                  "dpre sum", "exit barrier"]}
ENTRIES = ("nrv_talking_heads_cluster_fwd", "nrv_talking_heads_cluster_bwd",
           "nrv_cuda_error_string")


def _copy(src: Path, dst: Path, timers: bool) -> Path:
    """The headers and the two cluster sources of ``src`` in ``dst/csrc``,
    with the timers put in when ``timers``."""
    csrc = dst / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for path in src.glob("*.cuh"):
        shutil.copy(path, csrc)
    # the library's error strings
    error_src = 'extern "C" const char* nrv_cuda_error_string(int e) ' \
                '{ return cudaGetErrorString((cudaError_t)e); }\n'
    (csrc / "errors.cu").write_text('#include <cuda_runtime.h>\n' + error_src)
    for i, name in enumerate(SOURCES):
        text = (src / name).read_text()
        if timers:
            anchor = '#include "talking_heads_cluster.cuh"'
            if anchor not in text:
                raise RuntimeError(f"{name}: no include line to put the timers before")
            text = text.replace(anchor, TIMERS + anchor, 1)
            text += READER % (f"nrv_thc_phases_{('fwd', 'bwd')[i]}", SLOTS)
        (csrc / name).write_text(text)
    return csrc


def _open(path: Path, timers: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build._ENTRIES[name]
        fn.restype = ctypes.c_char_p if name == "nrv_cuda_error_string" else ctypes.c_int
    if timers:
        for direction in ("fwd", "bwd"):
            fn = getattr(lib, f"nrv_thc_phases_{direction}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def libraries(src: Path, root: Path):
    """(clean, timed) libraries of the sources in ``src``, built under ``root``."""
    def one(timers):
        out = root / ("timed" if timers else "clean")
        return _open(build.build(_copy(src, out, timers), out), timers)

    with ThreadPoolExecutor(2) as pool:
        clean, timed = pool.map(one, (False, True))
    return clean, timed


def read_phases(lib, direction):
    out = (ctypes.c_ulonglong * SLOTS)()
    if getattr(lib, f"nrv_thc_phases_{direction}")(ctypes.addressof(out)) != 0:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a directory of kernel sources (repeat for several)")
    ap.add_argument("--shape", default="128x8x196x196", help="B x H x N x N")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-final", action="store_true", help="no final row norm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_th_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}")
    dirs = [d.resolve() for d in (args.csrc or [build.CSRC])]
    shape = tuple(int(x) for x in args.shape.split("x"))
    iters, final_row = args.iters, not args.no_final
    root = Path(__file__).resolve().parents[1] / "build" / "th_phases"
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = list(pool.map(lambda i: libraries(dirs[i], root / str(i)), range(len(dirs))))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dots = 2 * torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    pre, post = (torch.randn(shape[1], shape[1], generator=gen, device=dev) for _ in range(2))
    out_p, vecs_p = th.talking_heads_fwd_plain(dots, pre, post, iters, final_row)
    ds_p = th.talking_heads_bwd_plain(dots, g, vecs_p, pre, post, iters, final_row)[0]
    real = build.load_library

    def run(lib, direction):
        build.load_library = lambda: lib  # the wrappers launch this library
        try:
            if direction == "fwd":
                return th.talking_heads_fwd_cuda(dots, pre, post, iters, final_row,
                                                 branch="cluster")
            return th.talking_heads_bwd_cuda(dots, g, vecs_p, pre, post, iters, final_row,
                                             branch="cluster")
        finally:
            build.load_library = real

    times = {i: {"fwd": [], "bwd": []} for i in range(len(dirs))}
    for i, (clean, _) in enumerate(libs):
        out_k, _ = run(clean, "fwd")
        ds_k = run(clean, "bwd")[0]
        torch.cuda.synchronize()
        err_o = (out_k - out_p).abs().max().item()
        err_d = (ds_k - ds_p).abs().max().item()
        ok = (torch.allclose(out_k, out_p, atol=1e-4, rtol=1e-3)
              and torch.allclose(ds_k, ds_p, atol=1e-4, rtol=1e-3))
        print(f"[{i}] {dirs[i]}: out err {err_o:.3g}, d dots err {err_d:.3g}"
              + ("" if ok else " DISAGREES"))
    order = list(range(len(dirs)))
    for i in order + order[::-1]:
        for direction in ("fwd", "bwd"):
            times[i][direction].append(cuda_ms(lambda: run(libs[i][0], direction)))
    for i in order:
        t = {d: sum(v) / len(v) for d, v in times[i].items()}
        print(f"[{i}] {list(shape)} f32 ({iters}, {'final' if final_row else 'no final'}): "
              f"fwd {t['fwd']:.4f} ms (turns {', '.join(f'{x:.4f}' for x in times[i]['fwd'])}), "
              f"bwd {t['bwd']:.4f} ms (turns {', '.join(f'{x:.4f}' for x in times[i]['bwd'])})")
    blocks = shape[0] * shape[1]
    for i in order:
        timed = libs[i][1]
        for direction in ("fwd", "bwd"):
            ms = cuda_ms(lambda: run(timed, direction))
            read_phases(timed, direction)
            run(timed, direction)
            cycles = read_phases(timed, direction)
            names = PHASES[direction]
            per_block = [c / blocks for c in cycles[:len(names)]]
            print(f"[{i}] {direction} with timers {ms:.4f} ms, cycles a block "
                  f"{sum(per_block):.0f}: "
                  + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(names, per_block)))
    print(f"device: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
