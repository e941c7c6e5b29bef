"""The readings that the limits of a cell's correctness comparison are set
from, on the card at the cell's own size: the program's first steps against
the reference on each seed (the lower readings), the control, the reference
with its products' operands rounded to fp8 (e4m3, per-tensor scale), on
each control seed, and the program with half of each batch left out (the
loss a mean over the rest) on each fault seed (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3]

One JSON line a reading, then one with the largest program reading and the
smallest control and fault reading of each number. The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch(state) -> None:
    """Fault: each step sees the first half of its batch only."""
    step = state.train_step
    state.train_step = lambda x, y: step(x[: x.shape[0] // 2], y[: y.shape[0] // 2])


def program_readings(h, cfg, mix, seed, device, fault=None) -> dict:
    import torch

    state, weights = h.build_state(cfg, mix, seed, device)
    if fault is not None:
        fault(state)
    batches = [h.draw_batch(cfg, seed, i, device, getattr(torch, cfg["dtype"]))
               for i in range(h.CHECKED_STEPS)]
    out = h.checked_steps(state, batches, weights)
    del state, weights, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness as h
    from benchmark.reference import common

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = h.find_workload(h.load_benchmark(), args.workload)
    cfg, mix = h.load_config(cell["config"]), h.load_mix(cell["traffic"])
    steps = h.CHECKED_STEPS
    worst = {}
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds))
    for seed in seeds:
        sides = {}
        if seed in args.seeds:
            sides["program"] = program_readings(h, cfg, mix, seed, device)
        if seed in args.fault_seeds:
            sides["half_batch"] = program_readings(h, cfg, mix, seed, device, half_batch)
        if seed in args.control_seeds:
            sides["control"] = h.reference_steps(cfg, mix, seed, device, steps, common.fp8)
        ref = h.reference_steps(cfg, mix, seed, device, steps)
        for side, got in sides.items():
            numbers = h.compare(got, ref)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              **numbers, "losses": got["losses"],
                              "reference_losses": ref["losses"]}), flush=True)
            for name in h.CHECK_NAMES:
                pick = max if side == "program" else min
                key = (side, name)
                worst[key] = pick(worst.get(key, numbers[name]), numbers[name])
    print(json.dumps({"workload": args.workload, "summary": {
        f"{side}.{name}": v for (side, name), v in sorted(worst.items())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
