"""Build the hand-written CUDA kernels into one shared library with a plain C
interface, and load it with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) at first use,
into ``build/kernels/`` at the root of the checkout: one ``nvcc -c`` for each
source, all started together, then one link. Each source is compiled with
``-Xptxas -v``, and its report (registers, shared memory, spills) goes to a
text file beside the library (``ptxas_log``). The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. The build writes to temporary names and renames the
library into place, so concurrent processes never load a half-written file.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__all__ = ["LaunchCounts", "build", "build_dir", "by_device", "check_operand", "error_string",
           "load_library", "open_library", "ptr", "ptxas_log", "raise_on", "sources", "stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (name, argtypes); each returns cudaGetLastError()
_ENTRIES = {
    "nrv_packed_attention_fwd": (
        # qkv, out, vecs, scratch, dtype, B, N, H, D, scale, robust, iters,
        # final_row, n_slots, stream
        [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _VP]),
    "nrv_packed_attention_bwd": (
        # qkv, dout, vecs, dqkv, scratch, dtype, B, N, H, D, scale, robust,
        # iters, final_row, n_slots, stream
        [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _VP]),
    # qkv, out, vecs, B, N, H, D, scale, robust, iters, final_row, grid,
    # stream
    "nrv_packed_resident_fwd": ([_VP] * 3 + [_I] * 4 + [_F] + [_I] * 4 + [_VP]),
    # qkv, dout, vecs, dqkv, terms (unused: null), B, N, H, D, scale, robust,
    # iters, final_row, grid, stream
    "nrv_packed_resident_bwd": ([_VP] * 5 + [_I] * 4 + [_F] + [_I] * 4 + [_VP]),
    # N, D
    "nrv_packed_resident_fits": ([_I] * 2),
    "nrv_biased_attention_fwd": (
        # q, k, v, bias, out, vecs, dtype, BW, H, N, D, DV, nW, scale, robust,
        # iters, final_row, stream
        [_VP] * 6 + [_I] * 7 + [_F, _I, _I, _I, _VP]),
    "nrv_biased_attention_bwd": (
        # q, k, v, bias, dout, vecs, dq, dk, dv, partial, dbias, dtype, BW, H,
        # N, D, DV, nW, scale, robust, iters, final_row, chunks, per_chunk,
        # stream
        [_VP] * 11 + [_I] * 7 + [_F] + [_I] * 5 + [_VP]),
    # q, k, v, bias, out, vecs, BW, H, N, D, DV, nW, scale, robust, iters,
    # final_row, chunks, per, stream (bf16)
    "nrv_biased_resident_fwd": ([_VP] * 6 + [_I] * 6 + [_F] + [_I] * 5 + [_VP]),
    # q, k, v, bias, dout, vecs, dq, dk, dv, partial, dbias, BW, H, N, D, DV,
    # nW, scale, robust, iters, final_row, chunks, per, stream (bf16)
    "nrv_biased_resident_bwd": ([_VP] * 11 + [_I] * 6 + [_F] + [_I] * 5 + [_VP]),
    # N, D, DV, robust, iters
    "nrv_biased_resident_fits": ([_I] * 5),
    # N, D, DV, robust, iters, bwd
    "nrv_biased_resident_blocks": ([_I] * 6),
    # logits, out, vecs, scratch, dtype, K, N, iters, final_row, blocks, stream
    "nrv_sinkhorn_softmax_fwd": ([_VP] * 4 + [_I] * 6 + [_VP]),
    # logits, g, vecs, ds, scratch, dtype, K, N, iters, final_row, blocks,
    # stream
    "nrv_sinkhorn_softmax_bwd": ([_VP] * 5 + [_I] * 6 + [_VP]),
    # logits, out, va, vb, scratch, dtype, K, NR, NC, iters, final_row,
    # blocks, stream
    "nrv_sinkhorn_softmax_rect_fwd": ([_VP] * 5 + [_I] * 7 + [_VP]),
    # logits, g, va, vb, ds, scratch, dtype, K, NR, NC, iters, final_row,
    # blocks, stream
    "nrv_sinkhorn_softmax_rect_bwd": ([_VP] * 6 + [_I] * 7 + [_VP]),
    # dots, pre, post, out, vecs, w, dtype, B, H, N, iters, final_row, stream
    "nrv_talking_heads_fwd": ([_VP] * 6 + [_I] * 6 + [_VP]),
    # dots, g, vecs, pre, post, ds, dpre, dpost, dm, part, dtype, B, H, N,
    # iters, final_row, stream
    "nrv_talking_heads_bwd": ([_VP] * 10 + [_I] * 6 + [_VP]),
    # dots, pre, post, out, vecs, dtype, B, H, N, iters, final_row, stream
    "nrv_talking_heads_cluster_fwd": ([_VP] * 5 + [_I] * 6 + [_VP]),
    # dots, g, vecs, pre, post, ds, dpre, dpost, part, dtype, B, H, N, iters,
    # final_row, stream
    "nrv_talking_heads_cluster_bwd": ([_VP] * 9 + [_I] * 6 + [_VP]),
    # dtype, H, N
    "nrv_talking_heads_cluster_fwd_clusters": ([_I] * 3),
    # dtype, H, N, iters, final_row
    "nrv_talking_heads_cluster_bwd_clusters": ([_I] * 5),
    # q, k, v, out, av, bv, dtype, K, N, M, D, scale, iters, final_row, tq,
    # stream
    "nrv_streaming_attention_fwd": ([_VP] * 6 + [_I] * 5 + [_F] + [_I] * 3 + [_VP]),
    # q, k, v, g, av, bv, dq, dk, dv, acc, rows, dtype, K, N, M, D, scale,
    # iters, final_row, tq, stream
    "nrv_streaming_attention_bwd": ([_VP] * 11 + [_I] * 5 + [_F] + [_I] * 3 + [_VP]),
    # N
    "nrv_streaming_split_splits": ([_I]),
    # q, k, v, out, av, bv, part, K, N, M, D, scale, iters, final_row, stream
    # (bf16, D = 64)
    "nrv_streaming_split_fwd": ([_VP] * 7 + [_I] * 4 + [_F] + [_I] * 2 + [_VP]),
    # q, k, v, g, av, bv, dq, dk, dv, part, U, W, go, rho, us, ws, K, N, M, D,
    # scale, iters, final_row, stream (bf16, D = 64)
    "nrv_streaming_split_bwd": ([_VP] * 16 + [_I] * 4 + [_F] + [_I] * 2 + [_VP]),
    # q, k, v, out, vecs, dtype, K, N, D, DV, scale, robust, iters, final_row,
    # stream
    "nrv_fused_attention_fwd": ([_VP] * 5 + [_I] * 5 + [_F] + [_I] * 3 + [_VP]),
    # q, k, v, g, vecs, dq, dk, dv, dtype, K, N, D, DV, scale, robust, iters,
    # final_row, stream
    "nrv_fused_attention_bwd": ([_VP] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_VP]),
    # q, k, v, out, vecs, K, N, D, DV, scale, robust, iters, final_row,
    # stream (bf16)
    "nrv_fused_resident_fwd": ([_VP] * 5 + [_I] * 4 + [_F] + [_I] * 3 + [_VP]),
    # q, k, v, g, vecs, dq, dk, dv, K, N, D, DV, scale, robust, iters,
    # final_row, stream (bf16)
    "nrv_fused_resident_bwd": ([_VP] * 8 + [_I] * 4 + [_F] + [_I] * 3 + [_VP]),
    # N, D, DV, robust, iters
    "nrv_fused_resident_fits": ([_I] * 5),
    # x, g, b, y, dtype, R, D, eps, stream
    "nrv_fused_ln_fwd": ([_VP] * 4 + [_I] * 3 + [_F, _VP]),
    # x, g, dy, dx, dg_part, db_part, dg, db, dtype, R, D, eps, stream
    "nrv_fused_ln_bwd": ([_VP] * 8 + [_I] * 3 + [_F, _VP]),
    # R, D
    "nrv_fused_ln_bwd_blocks": ([_I] * 2),
    "nrv_cuda_error_string": ([_I]),
}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def build_dir() -> Path:
    """``build/kernels/`` at the root of the checkout holding the package."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, out_dir: Path | None = None) -> Path:
    """Compile the library of the sources in ``csrc`` (the package's by
    default) into ``out_dir`` (``build_dir()``) unless a build of these
    sources exists; returns its path."""
    out = (out_dir or build_dir()) / f"libnrv_kernels_{_digest(csrc)}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sources(csrc):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *compile_flags, "-I", str(csrc), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    objs = [obj for _, obj, _ in jobs]
    try:
        report = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{stdout}\n{stderr}")
            report.append(f"== {Path(cmd[-1]).name}\n{stdout}{stderr}")
        ptxas_log(out).write_text("".join(report))
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def ptxas_log(library: Path) -> Path:
    """The ``-Xptxas -v`` report of the build of ``library``: a section a
    source, each headed by ``== <file name>``."""
    return library.with_suffix(".ptxas.txt")


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare every entry's argument and result
    types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "nrv_cuda_error_string" else ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load once per process."""
    return open_library(build())


def error_string(err: int) -> str:
    return load_library().nrv_cuda_error_string(err).decode()


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry point (null for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({error_string(err)})")


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a C entry point."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_operand(kernel: str, name: str, t: torch.Tensor, like: torch.Tensor,
                  dtype=None, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of
    ``dtype`` (``like``'s by default) on ``like``'s device, and of
    ``shape`` when one is given."""
    dtype = dtype or like.dtype
    if t.device != like.device or t.dtype != dtype or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous, 16-byte "
                         f"aligned {dtype} tensor on {like.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} {tuple(t.shape)} is not {list(shape)}")


def by_device(cuda_fn, plain_fn, x: torch.Tensor, *args):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor or a
    meta one (shapes alone, as when a model's FLOPs are counted on the meta
    device)."""
    if x.is_cuda:
        return cuda_fn(x, *args)
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel path for device {x.device}")
    return plain_fn(x, *args)


class LaunchCounts:
    """Kernel launches since the last ``reset``; each wrapper adds one
    where it launches its kernel, and nowhere else."""

    def __init__(self):
        self.fwd = 0
        self.bwd = 0

    def reset(self):
        self.fwd = 0
        self.bwd = 0
