"""Run one cell of the benchmark once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``noise_robust_vit_tpu_torch``). With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics; the numbers compared for ``correct`` are the last
lines of standard error and the last key of the result line. Exits non-zero,
printing no result, without a CUDA device, without the port, or where the
run has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load: JAX, its libraries and the JAX
# package the port was made from (``noise_robust_vit_tpu_torch`` is another
# name, compared whole)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "noise_robust_vit_tpu"})


def forbidden_loaded(modules) -> list[str]:
    """The top-level names in ``modules`` that are in ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in modules} & FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # this folder's modules are imported as the package ``benchmark``; the
    # folder itself stays off the path, so no module of it shadows another
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("run: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "noise_robust_vit_tpu_torch" / "__init__.py").is_file():
        print("run: the port (noise_robust_vit_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from benchmark import harness

    bench = harness.load_benchmark()
    cell = harness.find_workload(bench, args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    # load from one process with few threads: nothing in the window computes
    # on the CPU, so an intra-op pool would only stand idle beside the threads
    # that enqueue the step (forward on this one, backward on autograd's)
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START, bench)
    loaded = forbidden_loaded(list(sys.modules))
    if loaded:
        print(f"run: the run loaded {loaded}; the port must run without JAX",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check: {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
