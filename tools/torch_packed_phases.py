#!/usr/bin/env python3
"""Where the time of the resident packed-qkv kernels goes, on one CUDA GPU.

Copies the package's kernel sources to ``build/packed_phases/csrc`` with
``clock64()`` timers at the resident kernels' phase boundaries (each
boundary a barrier: the block's in the forward, the consumer warpgroups'
in the backward; thread 0 of every block adds the cycles since the
previous one to its slot), builds that copy into its own library, and runs
the kernels at SimpleViT-B/16's ``[256, 196, 2304]`` (3, final) and
vit_b_16's ``[256, 197, 2304]`` (4, no final) bf16, vanilla and robust.
Prints the kernels' times (the barriers cost a little) and the cycles an
item spends in each phase, averaged over the blocks that ran, beside the
card's name and power limit.

Forward phases (timers at anchor lines): wait for k (and v, vanilla), q·kᵀ
and the softmax (with P·V when vanilla), the Sinkhorn chain, wait for v,
the output product. Backward phases (behind the kernel's ``PRES_PHASE``
markers): wait for k and q, A = exp(q·kᵀ − lse), wait for dout and v, t1
(vanilla: dV) staged, multiplied and its partials sent to the other block
of the cluster, o/a (vanilla: dA's row sums), da (vanilla: dS), t1's
partials received (dV, db), the reverse chain, dS, wait for k and q, dK
staged, multiplied and its partials sent, dQ, dK's partials received
(after the next item's A), the step to the next item. Vanilla's chain and
dS phases are empty.

    python3 tools/torch_packed_phases.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from noise_robust_vit_tpu_torch.ops.cuda import build  # noqa: E402
from noise_robust_vit_tpu_torch.ops.cuda import packed_attention as pa  # noqa: E402

SLOTS = 16
MAX_BLOCKS = 1024  # timer slots: the wrappers' grid is at most one block a SM
TIMERS = '''
static __device__ unsigned long long g_phase[%d * 16];
#define PH_INIT unsigned long long ph_last = clock64();
#define PH(k) do { __syncthreads(); if (threadIdx.x == 0) { \\
  unsigned long long now = clock64(); g_phase[blockIdx.x * 16 + (k)] += now - ph_last; \\
  ph_last = now; } } while (0)
'''
READER = '''
extern "C" int %s(unsigned long long* out) {
  static unsigned long long zero[%d * 16];
  cudaMemcpyFromSymbol(out, nrv::res::g_phase, sizeof(zero));
  cudaMemcpyToSymbol(nrv::res::g_phase, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
'''
# (anchor, replacement) pairs: the timers go in at these lines
FWD = [
    ("uint32_t ph_k = 0, ph_v = 0, ph_q = 0;\n", "uint32_t ph_k = 0, ph_v = 0, ph_q = 0;\n  PH_INIT\n"),
    ("      hopper::mbar_wait(&bars[1], ph_v);\n      ph_v ^= 1;\n    }\n",
     "      hopper::mbar_wait(&bars[1], ph_v);\n      ph_v ^= 1;\n    }\n    PH(0);\n"),
    ("    if (robust) {\n      hopper::fence_proxy_async();",
     "    PH(1);\n    if (robust) {\n      hopper::fence_proxy_async();"),
    ("      hopper::mbar_wait(&bars[1], ph_v);\n      ph_v ^= 1;\n      resident_product",
     "      PH(2);\n      hopper::mbar_wait(&bars[1], ph_v);\n      ph_v ^= 1;\n      PH(3);\n"
     "      resident_product"),
    ("    hopper::fence_proxy_async();\n    __syncthreads();  // every buffer",
     "    PH(4);\n    hopper::fence_proxy_async();\n    __syncthreads();  // every buffer"),
]
# The backward's markers: a barrier of its two consumer warpgroups (named
# barrier 1; the producer warp never joins), then thread 0's lap
BWD_TIMERS = '''
#define PRES_PHASE_INIT unsigned long long ph_last = clock64();
#define PRES_PHASE(k) do { asm volatile("bar.sync 1, 256;" ::: "memory"); \\
  if (threadIdx.x == 0) { unsigned long long now = clock64(); \\
  g_phase[blockIdx.x * 16 + (k)] += now - ph_last; ph_last = now; } } while (0)
'''
NAMES = {"fwd": ["wait k", "q·kᵀ + softmax", "chain", "wait v", "output product"],
         "bwd": ["wait k, q", "A", "wait dout, v", "t1 (dV) sent", "o/a (dA's row sums)",
                 "da (dS)", "t1 received", "chain", "dS", "wait k, q", "dK sent",
                 "dQ", "dK received", "next item"]}


def instrumented(dst: Path) -> Path:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)

    def edit(name, pairs, tail=""):
        text = (dst / name).read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: the timer anchor {old!r} is gone")
            text = text.replace(old, new, 1)
        (dst / name).write_text(text + tail)

    edit("packed_resident.cuh", [("namespace nrv {\nnamespace res {",
                                  "namespace nrv {\nnamespace res {\n" + TIMERS % MAX_BLOCKS)])
    edit("packed_resident_fwd.cu", FWD, READER % ("nrv_phases_fwd", MAX_BLOCKS))
    edit("packed_resident_bwd.cu", [('#include "cluster.cuh"',
                                      BWD_TIMERS + '#include "cluster.cuh"')],
         READER % ("nrv_phases_bwd", MAX_BLOCKS))
    return dst


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {card.strip()}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms > MAX_BLOCKS:
        print(f"{sms} SMs: more blocks than the {MAX_BLOCKS} timer slots", file=sys.stderr)
        return 1
    csrc = instrumented(build.build_dir().parent / "packed_phases" / "csrc")
    lib = build.open_library(build.build(csrc, csrc.parent / "lib"))
    build.load_library = lambda: lib  # the wrappers launch the instrumented kernels
    buf = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)

    def phases(direction):
        """The cycles of the blocks that ran (the backward launches as many
        clusters as the card holds, which may be fewer blocks than SMs)."""
        getattr(lib, f"nrv_phases_{direction}")(buf.ctypes.data)
        laps = buf.reshape(MAX_BLOCKS, SLOTS).astype(np.float64)
        return laps[laps.sum(1) > 0]

    h, d, reps = 12, 64, 5
    for n, iters, final_row in ((196, 3, True), (197, 4, False)):
        gen = torch.Generator(device=dev).manual_seed(n)
        qkv = torch.randn(256, n, 3 * h * d, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(256, n, h * d, device=dev, generator=gen).to(torch.bfloat16)
        items = 256 * h
        cluster = 2 if n > pa._RES_BLOCK_ROWS else 1  # the backward's blocks an item
        for robust in (False, True):
            args = (h, d, d ** -0.5, robust, iters, final_row)
            _, vecs = pa.packed_attention_fwd_cuda(qkv, *args, branch="resident")
            pa.packed_attention_bwd_cuda(qkv, g, vecs, *args, branch="resident")
            torch.cuda.synchronize()
            phases("fwd"), phases("bwd")  # drop the warm-up's cycles
            line = f"[256,{n},{3 * h * d}] robust={int(robust)} ({iters}, {int(final_row)})"
            for direction, fn in (
                    ("fwd", lambda: pa.packed_attention_fwd_cuda(qkv, *args, branch="resident")),
                    ("bwd", lambda: pa.packed_attention_bwd_cuda(qkv, g, vecs, *args,
                                                                 branch="resident"))):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                laps = phases(direction)
                per_block = items * (cluster if direction == "bwd" else 1) / len(laps)
                cycles = laps.mean(0) / (per_block * reps)
                parts = ", ".join(f"{name} {cycles[i]:.0f}"
                                  for i, name in enumerate(NAMES[direction]))
                line += (f"\n  {direction} {start.elapsed_time(end) / reps:.4f} ms; cycles an "
                         f"item: {parts}; sum {cycles.sum():.0f}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
