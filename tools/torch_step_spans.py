#!/usr/bin/env python3
"""The port's step tracer on one benchmark cell on a CUDA card: whether it
leaves the step's numbers alone, what its spans read, and what it costs.

From the root of a checkout, for the cell named in ``BENCHMARK.json``, with
the benchmark's own set-up (``benchmark/harness.py``: weights, batches and
stochastic-depth draws from ``--seed``):

1. three train states, the tracer off, on and off, each taking the cell's
   checked steps: whether the traced state's losses and parameters equal
   the first untraced state's bit for bit, beside whether the two untraced
   ones do (the card repeating its own step);
2. on the last state, after the warm-up steps, stretches of ``--seconds``
   of the benchmark's closed loop (``harness.measure``), the tracer off, on,
   on, off. Each stretch: img/s, host ms a step (``host_enqueue_ms``), the
   median step ms, and the card's state read once after its closing
   synchronise (``benchmark/spans.py::card_state``). A traced stretch: the
   tracer started before it and drained after it, its spans line, the
   readers ``forward_ms``, ``backward_ms`` and ``host_lead_ms_p5``, the sum
   of the phases' medians over the median step, the least lead of every
   step and of those the reader counts, the drift between the anchors.

Prints a line a stretch on standard error and one JSON line, with the
card's name and power limit, on standard output; each traced stretch's
records go to ``<--out>/<cell>.<seed>.<k>.json`` (``build/spans`` by
default).

    python3 tools/torch_step_spans.py --workload swin_t.robust --seed 2147483749 --seconds 51
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness, spans  # noqa: E402
from benchmark.metrics import backward_ms, forward_ms, host_lead_ms_p5  # noqa: E402
from noise_robust_vit_tpu_torch.train import StepTracer  # noqa: E402

READERS = {"forward_ms": forward_ms, "backward_ms": backward_ms,
           "host_lead_ms_p5": host_lead_ms_p5}
ORDER = (False, True, True, False)


def checked(cfg, mix, seed, device, pool, traced: bool):
    """A fresh state's checked steps; returns the state, its losses and a
    copy of its parameters."""
    state, _ = harness.build_state(cfg, mix, seed, device)
    if traced:
        state.tracer = StepTracer(device)
        state.tracer.start()
    losses = torch.stack([state.train_step(*b) for b in pool[:harness.CHECKED_STEPS]])
    params = [p.detach().clone() for p in state.model.parameters()]
    state.tracer = None
    return state, losses, params


def same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


def stretch(state, pool, seconds, device, tracer):
    """One stretch of the closed loop, traced where ``tracer`` is given."""
    state.tracer = tracer
    if tracer is not None:
        tracer.start()
    win = harness.measure(state, pool, seconds, device)
    drained = tracer.drain() if tracer is not None else None
    card = spans.card_state(device)
    state.tracer = None
    out = {"traced": tracer is not None, "img_s": win["images"] / win["wall_s"],
           "steps": win["steps"], "host_enqueue_ms": 1e3 * win["host_s"] / win["steps"],
           "step_ms_median": statistics.median(win["step_ms"]), "card": card}
    if drained is None:
        return out, None
    records = drained["records"]
    ctx = SimpleNamespace(spans=records)
    out.update({name: r.read(ctx) for name, r in READERS.items()})
    medians = {p: statistics.median(spans.phase_ms(records, p)) for p in records[0]["phases"]}
    out.update(phase_medians_ms=medians,
               phases_over_step=sum(medians.values()) / out["step_ms_median"],
               lead_min_ms=min(spans.leads_ms(records, skip=0)),
               lead_min_counted_ms=min(spans.leads_ms(records)),
               drift_ms=drained["drift_ms"], traced_steps=len(records),
               log=spans.log_line(drained))
    return out, drained


def run(workload: str, seed: int, seconds: float, device, out_dir: Path, cfg=None) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_workload(bench, workload)
    cfg = cfg or harness.load_config(cell["config"])
    mix = harness.load_mix(cell["traffic"])
    if device.type == "cuda":
        from noise_robust_vit_tpu_torch.ops.cuda.build import load_library

        load_library()
    pool = [harness.draw_batch(cfg, seed, i, device, getattr(torch, cfg["dtype"]))
            for i in range(harness.POOL_BATCHES)]
    state, runs = None, []
    for traced in (False, True, False):
        state = None  # the previous state is freed before the next is built
        state, losses, params = checked(cfg, mix, seed, device, pool, traced)
        runs.append((losses, params))
    result = {"workload": workload, "seed": seed, "seconds": seconds,
              "losses": [float(x) for x in runs[0][0]],
              "traced_equals_untraced": same(runs[0], runs[1]),
              "untraced_repeats": same(runs[0], runs[2])}
    del runs
    for i in range(harness.WARMUP_STEPS):
        state.train_step(*pool[(harness.CHECKED_STEPS + i) % len(pool)])
    tracer = StepTracer(device)
    stretches = []
    for k, traced in enumerate(ORDER):
        s, drained = stretch(state, pool, seconds, device, tracer if traced else None)
        harness.log(f"stretch {k} ({'traced' if traced else 'untraced'}): "
                    f"{json.dumps({x: v for x, v in s.items() if x != 'log'})}")
        if drained is not None:
            harness.log(s.pop("log"))
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{workload}.{seed}.{k}.json").write_text(json.dumps(drained))
        stretches.append(s)
    off = [s["img_s"] for s in stretches if not s["traced"]]
    on = [s["img_s"] for s in stretches if s["traced"]]
    result.update(stretches=stretches, on_cost=1.0 - statistics.mean(on) / statistics.mean(off))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "spans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda")
    result = run(args.workload, args.seed, args.seconds, device, args.out)
    result["device"] = {"name": torch.cuda.get_device_name(device),
                        "power_limit_w": (result["stretches"][0]["card"] or {}).get("power.limit")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
