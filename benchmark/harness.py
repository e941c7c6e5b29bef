"""One run of one cell: find the cell's files by name, set up the train state
from the seed, take the checked first steps, measure the window and the
device's time a step (or the traced stretch, with the port's step spans,
and the profile), then free the program and hold its first steps against
the plain reference.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by name:

- ``configs/<config>.json``: the model's sizes, batch, optimizer, the
  attention calls a step makes, and the name of its reference module;
- ``reference/<reference>.py``: the plain float32 model, its analytic
  FLOPs, and ``COUPLES_IMAGES`` where its layers couple a batch's images;
- ``mixes/<traffic>.json``: the attention mode;
- ``metrics/<metric>.py``: a reader of one per-layer metric;
- ``limits/<workload>.json``: the limits of the correctness comparison.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark import arith, spans
from benchmark import trace as tracing
from benchmark.reference import common

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every cell's step loop: distinct batches drawn for the pool the steps cycle
# over, the first steps checked against the reference (the limits were set
# from three), and the warm-up steps after them, before the window
POOL_BATCHES = 4
CHECKED_STEPS = 3
WARMUP_STEPS = 2
# steps of an untraced run's device-only profile after its window, whose
# busy time a step is device_step_ms
DEVICE_STEPS = 8
# images a block of the reference's forward and backward, where its model
# treats each image apart
REFERENCE_BLOCK = 32


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- discovery

def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def load_limits(workload: str) -> dict | None:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else None


def reference_module(cfg: dict):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def reference_block(cfg: dict, ref) -> int:
    """Images a block of the reference's steps: the whole batch where the
    reference module states ``COUPLES_IMAGES = True`` (a layer, such as
    BatchNorm in training, computes over the images of the batch, so a
    smaller block is another function), else ``REFERENCE_BLOCK``."""
    return cfg["batch"] if getattr(ref, "COUPLES_IMAGES", False) else REFERENCE_BLOCK


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports:
    those whose list names it; of those with no list, every end-to-end
    metric, and every per-layer metric whose ``moves`` the cell reports."""
    if kind == "end_to_end":
        return [m for m in bench[kind] if workload in m.get("workloads", [workload])]
    ends = {m["name"] for m in cell_metrics(bench, workload, "end_to_end")}
    return [m for m in bench[kind]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in ends)]


def attention_of(cfg: dict, mix: dict) -> dict | None:
    """The configuration's attention functions and calls under the mix's
    attention mode, or None where no hand-written attention serves it."""
    return cfg.get("attention", {}).get(mix["attention"])


# ------------------------------------------------------------------ inputs

def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed."""
    return int(hashlib.sha256(f"{seed}/{stream}".encode()).hexdigest()[:15], 16)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """Float32 weights for the named shapes, drawn on ``device`` from the seed
    in one call: a matrix or kernel (``...weight``, two or more axes)
    N(0, 1/fan_in); a 1-D ``weight`` 1 + N(0, 0.02²); biases and tables
    N(0, 0.02²). Names are taken in sorted order, so the draw depends on the
    names and shapes alone."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    flat = torch.randn(total, generator=_generator(device, sub_seed(seed, "weights")),
                       device=device)
    out, o = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        z = flat[o:o + math.prod(shape)].view(shape)
        o += math.prod(shape)
        if n.endswith("weight") and len(shape) >= 2:
            out[n] = z * common.lecun_std(shape)
        elif n.endswith("weight"):
            out[n] = 1.0 + 0.02 * z
        else:
            out[n] = 0.02 * z
    return out


def draw_batch(cfg: dict, seed: int, index: int, device, dtype):
    """Batch ``index`` of the run: NHWC images from N(0, 1) in ``dtype`` and
    labels uniform over the classes, drawn on ``device``."""
    gen = _generator(device, sub_seed(seed, f"batch{index}"))
    b, s = cfg["batch"], cfg["image_size"]
    images = torch.randn(b, s, s, cfg["channels"], generator=gen, device=device).to(dtype)
    labels = torch.randint(0, cfg["num_classes"], (b,), generator=gen, device=device)
    return images, labels


def draw_masks(cfg: dict, seed: int, steps: int, device) -> list | None:
    """The per-image stochastic-depth multipliers of the first ``steps``
    steps, in call order: the draws the model makes from the generator that
    ``create_model`` seeds with ``seed + 1`` (a float32 Bernoulli of the
    keep rate, of shape ``[B, 1, 1, 1]``, divided by the keep rate)."""
    rates = reference_module(cfg).drop_rates(cfg)
    if not rates:
        return None
    gen = _generator(device, seed + 1)
    out = []
    for _ in range(steps):
        step = []
        for rate in rates:
            keep = 1.0 - rate
            m = torch.empty((cfg["batch"], 1, 1, 1), dtype=torch.float32, device=device)
            step.append(m.bernoulli_(keep, generator=gen).reshape(-1) / keep)
        out.append(step)
    return out


# ------------------------------------------------------------ the program

def build_state(cfg: dict, mix: dict, seed: int, device):
    """The port's model from ``create_model`` (its stochastic depth seeded
    from ``seed``) with the benchmark's weights loaded, and its AdamW train
    state; returns ``(state, weights)``."""
    from noise_robust_vit_tpu_torch import create_model
    from noise_robust_vit_tpu_torch.train import create_train_state

    model = create_model(cfg["model"], num_classes=cfg["num_classes"],
                         image_size=cfg["image_size"], robust=mix["attention"] == "sinkhorn",
                         dtype=getattr(torch, cfg["dtype"]), device=device, seed=seed)
    params = dict(model.named_parameters())
    weights = draw_weights({n: tuple(p.shape) for n, p in params.items()}, seed, device)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    opt = cfg["optimizer"]
    state = create_train_state(model, lr=opt["lr"], weight_decay=opt["weight_decay"])
    want = {"lr": opt["lr"], "weight_decay": opt["weight_decay"],
            "betas": common.ADAMW_BETAS, "eps": common.ADAMW_EPS}
    for group in state.optimizer.param_groups:
        got = {k: tuple(v) if k == "betas" else v for k, v in group.items() if k in want}
        if got != want:
            raise RuntimeError(f"the program's AdamW is {got}, the reference's {want}")
    sched = cfg["sinkhorn"]
    for mod in model.modules():
        got = (getattr(mod, "sinkhorn_iters", sched["iters"]),
               getattr(mod, "final_row_norm", sched["final_row_norm"]))
        if got != (sched["iters"], sched["final_row_norm"]):
            raise RuntimeError(f"{type(mod).__name__} runs Sinkhorn {got}, the "
                               f"configuration states {sched}")
    return state, weights


def checked_steps(state, batches, weights: dict) -> dict:
    """The first steps through the window's own call: each step's loss, each
    leaf's first gradient as the optimizer received it (read back from
    AdamW's first moment after one step) and each leaf's change over all of
    them (on the host)."""
    params = dict(state.model.named_parameters())
    b1 = common.ADAMW_BETAS[0]
    losses, grad_norms = [], None
    for s, (images, labels) in enumerate(batches):
        losses.append(state.train_step(images, labels))
        if s == 0:
            # a leaf the optimizer holds no moment of received no gradient
            grad_norms = {n: (state.optimizer.state[p]["exp_avg"] / (1 - b1)).norm()
                          if "exp_avg" in state.optimizer.state.get(p, {}) else torch.zeros(())
                          for n, p in params.items()}
    deltas = {n: (p.detach() - weights[n]).cpu() for n, p in params.items()}
    return {"losses": [float(x) for x in losses],
            "grad_norms": {n: float(v) for n, v in grad_norms.items()}, "deltas": deltas}


def reference_steps(cfg: dict, mix: dict, seed: int, device, steps: int,
                    rnd=common.exact) -> dict:
    """The plain reference's first steps from the same seed: the same
    weights, batches and stochastic-depth draws, in float32 with TF32 off
    (or, with ``rnd``, its products' operands rounded)."""
    common.float32_exact()
    ref = reference_module(cfg)
    robust = mix["attention"] == "sinkhorn"
    weights = draw_weights(_param_shapes(cfg), seed, device)
    if set(weights) != ref.param_names(cfg):
        raise RuntimeError("the reference's parameters differ from the program's: "
                           f"{sorted(set(weights) ^ ref.param_names(cfg))[:8]}")
    batches = [draw_batch(cfg, seed, i, device, getattr(torch, cfg["dtype"]))
               for i in range(steps)]
    masks = draw_masks(cfg, seed, steps, device)

    def forward(p, images, step_masks):
        return ref.forward(p, images, cfg, robust, rnd=rnd, masks=step_masks)

    return common.train_steps(forward, weights, batches, cfg["optimizer"],
                              reference_block(cfg, ref), masks)


def _param_shapes(cfg: dict) -> dict:
    """The program's parameter names and shapes (its model built on the meta
    device, so nothing is drawn or allocated)."""
    from noise_robust_vit_tpu_torch import create_model

    model = create_model(cfg["model"], num_classes=cfg["num_classes"],
                         image_size=cfg["image_size"], device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


# -------------------------------------------------------------- comparison

CHECK_NAMES = ("loss_gap", "grad_gap", "update_gap", "update_gap_median")
# the update comparison leaves out, by the reference's first gradient, a
# leaf under LEAF_FLOOR of the median leaf's norm and an entry under
# ENTRY_FLOOR of its leaf's root-mean-square entry: Adam moves them by
# round-off alone. A key's bias under softmax lies there (at most 1.2e-7 of
# its leaf's), and under Sinkhorn, which is nearly invariant to a column
# shift, a query's bias (6e-10 to 1.7e-6)
LEAF_FLOOR = 1e-3
ENTRY_FLOOR = 1e-4


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, with the worst leaf of the first three:

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``: over the leaves, the largest gap between the program's
      and the reference's first-gradient norms, over the reference's norm
      of that leaf or of the median leaf, whichever is larger;
    - ``update_gap``: the same of the norms of each leaf's change over the
      checked steps. Left out of both sides' changes, by the reference's
      first gradient: a leaf whose norm is under ``LEAF_FLOOR`` of the
      median leaf's, and an entry under ``ENTRY_FLOOR`` of its leaf's
      root-mean-square entry;
    - ``update_gap_median``: the median leaf's gap of the same, which
      swings far less from seed to seed than the worst leaf's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    rg = ref["grads"]
    norms = {n: float(g.norm()) for n, g in rg.items()}
    med_g = statistics.median(norms.values())
    pg = prog.get("grad_norms") or {n: float(g.norm()) for n, g in prog["grads"].items()}
    grad = {n: abs(pg[n] - norms[n]) / max(norms[n], med_g) for n in rg}
    keep = {n: g.abs() >= ENTRY_FLOOR * norms[n] / math.sqrt(g.numel())
            for n, g in rg.items() if norms[n] >= LEAF_FLOOR * med_g}
    dp = {n: float(prog["deltas"][n][k].norm()) for n, k in keep.items()}
    dr = {n: float(ref["deltas"][n][k].norm()) for n, k in keep.items()}
    med_d = statistics.median(dr.values())
    upd = {n: abs(dp[n] - dr[n]) / max(dr[n], med_d) for n in dp}
    gw, uw = max(grad, key=grad.get), max(upd, key=upd.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[gw], "update_gap": upd[uw],
            "update_gap_median": statistics.median(upd.values()),
            "grad_worst": gw, "update_worst": uw,
            "counted": sum(int(k.sum()) for k in keep.values()),
            "left_out": sum(g.numel() for g in rg.values()) - sum(int(k.sum())
                                                                  for k in keep.values())}


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """Whether every compared number is within its limit; and the numbers
    beside their limits. A number whose limit is null is shown, not
    compared. No limits file: not correct."""
    checks = {}
    ok = limits is not None
    for name in CHECK_NAMES:
        limit = None if limits is None else limits.get(name)
        checks[name] = {"value": numbers[name], "limit": limit}
        if limit is not None and not numbers[name] <= limit:
            ok = False
    return ok, checks


# ------------------------------------------------------------------ timing

class _Mark:
    """A step boundary: a CUDA event on the stream, or the host clock where
    the run is on the CPU (the tests)."""

    def __init__(self, device):
        self.event = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
        if self.event is not None:
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, other: "_Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(other.event)
        return 1e3 * (other.t - self.t)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(state, pool, seconds: float, device) -> dict:
    """The closed loop: ``train_step`` over the pool, a mark after every
    step and the host's clock around every call, no synchronisation inside;
    the window closes with the synchronise after the last step launched
    before ``seconds`` ran out. Beside the marks, the host's clock at each
    one shows whether a slow step was the host's."""
    _sync(device)
    t0 = time.perf_counter()
    marks, losses, host, i, clocks = [_Mark(device)], [], 0.0, 0, [t0]
    while time.perf_counter() - t0 < seconds:
        images, labels = pool[i % len(pool)]
        a = time.perf_counter()
        losses.append(state.train_step(images, labels))
        host += time.perf_counter() - a
        marks.append(_Mark(device))
        clocks.append(time.perf_counter())
        i += 1
    _sync(device)
    wall = time.perf_counter() - t0
    steps_ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
    return {"steps": i, "wall_s": wall, "images": i * pool[0][0].shape[0],
            "step_ms": steps_ms, "host_s": host, "losses": losses,
            "host_ms": [1e3 * (b - a) for a, b in zip(clocks, clocks[1:])]}


@dataclass
class Context:
    """What a per-layer metric's reader reads: the stretch, its step spans
(the port's ``StepTracer`` records) and the profile after it."""

    cfg: dict
    mix: dict
    workload: str
    stretch: dict
    trace: object = None
    spans: list | None = None


# --------------------------------------------------------------------- run

def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: dict | None = None, fault=None) -> dict:
    """One run of ``workload``; returns the result line as a dict. ``fault``
    (tests only) wraps the state's ``train_step``."""
    bench = bench or load_benchmark()
    cell = find_workload(bench, workload)
    cfg, mix = load_config(cell["config"]), load_mix(cell["traffic"])
    limits = load_limits(workload)
    dtype = getattr(torch, cfg["dtype"])
    device = torch.device(device)
    checked = CHECKED_STEPS

    if device.type == "cuda":
        from noise_robust_vit_tpu_torch.ops.cuda.build import load_library

        t = time.perf_counter()
        load_library()
        log(f"setup: kernel library {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    state, weights = build_state(cfg, mix, seed, device)
    if fault is not None:
        fault(state)
    pool = [draw_batch(cfg, seed, i, device, dtype) for i in range(POOL_BATCHES)]
    _sync(device)
    log(f"setup: model, weights and pool {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    prog = checked_steps(state, pool[:checked], weights)
    del weights
    for i in range(WARMUP_STEPS):
        state.train_step(*pool[(checked + i) % len(pool)])
    _sync(device)
    log(f"setup: {checked} checked and {WARMUP_STEPS} warm-up steps "
        f"{time.perf_counter() - t:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    per_layer = None
    if trace:
        from noise_robust_vit_tpu_torch.train import StepTracer

        # the step spans over the stretch; the tracer's events are made here
        state.tracer = StepTracer(device)
        state.tracer.start()
    win = measure(state, pool, seconds, device)
    device_ms = None if trace else tracing.device_step_ms(state, pool, DEVICE_STEPS, device)
    if trace:
        drained = state.tracer.drain()
        state.tracer = None
        card = spans.card_state(device)
        log(spans.log_line(drained))
        prof = tracing.profile_steps(state, pool, cfg["profile_steps"], device)
        images = prof.steps * cfg["batch"]
        log(f"trace: img/s unprofiled stretch {win['images'] / win['wall_s']:.4f}, "
            f"profiled with host ops {images / prof.profiled_s:.4f}, device activity "
            f"alone (first to last device op) {images / prof.window_s:.4f}")
        ctx = Context(cfg, mix, workload, win, prof, drained["records"])
        per_layer = {}
        for m in cell_metrics(bench, workload, "per_layer"):
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    losses = [float(x) for x in win["losses"]]
    failed = sum(1 for x in losses if not math.isfinite(x))

    del state, pool, win["losses"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_steps(cfg, mix, seed, device, checked)
    numbers = compare(prog, ref)
    log(f"check: reference {time.perf_counter() - t:.3f} s; worst leaves: grad "
        f"{numbers['grad_worst']}, update {numbers['update_worst']}; entries left out of "
        f"the update: {numbers['left_out']} of {numbers['left_out'] + numbers['counted']}")
    log(f"check: losses program {prog['losses']} reference {ref['losses']}")
    ok, checks = judge(numbers, limits)

    if trace:
        metrics = per_layer
    else:
        metrics = {}
        p95 = arith.percentile(win["step_ms"], 95)
        values = {"train_img_s": win["images"] / win["wall_s"], "step_ms_p95": p95,
                  "device_step_ms": device_ms, "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            # off the card there is no device time: device_step_ms is left out
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        log_window(win, p95)
        log(f"window: img/s {win['images'] / win['wall_s']:.4f}; device ms a step "
            f"(busy, {DEVICE_STEPS} profiled steps after the window) {device_ms}")
    result = {"correct": ok and failed == 0, "attempted": win["steps"], "failed": failed,
              "metrics": metrics, "device": device_info(device, peak)}
    if trace:
        result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s,
                                card_state=card)
        result["breakdown"] = prof.breakdown()
    result["checks"] = checks
    return result


def log_window(win: dict, p95: float) -> None:
    """The window's steps on standard error: the median and 95th percentile,
    and the steps over 1.1× the median with their device and host
    milliseconds."""
    med = statistics.median(win["step_ms"])
    slow = [(i, round(t, 1), round(win["host_ms"][i], 1))
            for i, t in enumerate(win["step_ms"]) if t > 1.1 * med]
    log(f"window: {win['steps']} steps in {win['wall_s']:.3f} s; step ms median {med:.3f} "
        f"p95 {p95:.3f}; {len(slow)} steps over 1.1× the median (step, device ms, host ms): "
        f"{slow[:40]}")


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
