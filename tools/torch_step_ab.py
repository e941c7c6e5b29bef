#!/usr/bin/env python3
"""Train-step rate of models in two checkouts of the port, in turns on one CUDA GPU.

For each model, runs the bf16 train step (1000 classes, AdamW lr 1e-3, the
same inputs from seed 4) of checkout A, then B, B, A, each turn in a process
of its own that imports ``noise_robust_vit_tpu_torch`` from that checkout
(which builds its kernels into its own ``build/``). A turn times vanilla
then robust: the median img/s of ``--windows`` windows of ``--steps``
steps after one warm-up step, and the host's time to enqueue a step.
Prints each turn, then for each model and mode the mean of A's and of B's
turns and B / A, beside the card's name and power limit. A model named
more than once runs that many rounds of A, B, B, A.

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent  # the parent
    python3 tools/torch_step_ab.py build/parent . mobile_vit_xs:128:256 cvt_13:128:224
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(root: str, name: str, batch: int, image: int, steps: int, windows: int) -> None:
    """One turn: the step rates of ``name`` from the checkout at ``root``,
    printed as one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import noise_robust_vit_tpu_torch as pkg
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    where = Path(pkg.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2**62)))
    x = torch.randn((batch, image, image, 3), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=batch)).to(dev)
    result = {"root": root, "model": name}
    for robust in (False, True):
        model = create_model(name, num_classes=1000, image_size=image, robust=robust,
                             dtype=torch.bfloat16, device=dev, seed=0)
        state = create_train_state(model, lr=1e-3, weight_decay=0.05)
        float(state.train_step(x, y))  # warm-up
        rates, enqueue = [], []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = state.train_step(x, y)
            enqueue.append(1e3 * (time.perf_counter() - t0) / steps)
            float(loss)
            rates.append(batch * steps / (time.perf_counter() - t0))
        result["robust" if robust else "vanilla"] = {
            "img_s": statistics.median(rates), "windows": rates,
            "enqueue_ms": statistics.median(enqueue)}
        del model, state
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a", help="checkout A (e.g. the parent commit)")
    parser.add_argument("b", help="checkout B (e.g. the change)")
    parser.add_argument("models", nargs="+", help="name:batch:image")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--windows", type=int, default=5)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        name, batch, image = args.models[0].split(":")
        worker(args.a, name, int(batch), int(image), args.steps, args.windows)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for spec in args.models:
        for label, root in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
            out = subprocess.run([sys.executable, __file__, root, root, spec, "--worker",
                                  "--steps", str(args.steps), "--windows", str(args.windows)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                raise RuntimeError(f"turn {label} of {spec} in {root} failed")
            turn = json.loads(out.stdout.strip().splitlines()[-1])
            turn["label"] = label
            turns.append(turn)
            print(f"turn {label} {spec} ({root}): " + ", ".join(
                f"{mode} {turn[mode]['img_s']:.2f} img/s "
                f"{[round(r, 2) for r in turn[mode]['windows']]} enqueue "
                f"{turn[mode]['enqueue_ms']:.2f} ms/step" for mode in ("vanilla", "robust")),
                flush=True)
    for name in dict.fromkeys(spec.split(":")[0] for spec in args.models):
        for mode in ("vanilla", "robust"):
            mean = {label: statistics.mean(t[mode]["img_s"] for t in turns
                                           if t["model"] == name and t["label"] == label)
                    for label in ("A", "B")}
            print(f"{name} {mode} bf16 {card}: A {mean['A']:.2f} img/s, B {mean['B']:.2f} "
                  f"img/s, B/A {mean['B'] / mean['A']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
