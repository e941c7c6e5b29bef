"""The traced run's profile: a few train steps under ``torch.profiler``
(host ops and device activity), exported as a Chrome trace into the
temporary directory, read back and reduced to what the per-layer readers
need: each device op's interval and the host ops that enclosed its launch.

Each profiled step is wrapped in the benchmark's own span,
``benchmark.step``. A device op is attributed to every host op (``cpu_op``
or ``user_annotation``) open on the launching thread when it was launched:
the launch is found by the correlation id that CUPTI gives both.

Recording host ops costs the host some microseconds an op, which stretches
a step that the host binds. So the device's busy and idle time come from a
second profile of as many steps that records device activity alone, from
its first device op to its last, the queue drained before and after. An
untraced run takes that second profile alone after its window, for the
device's time a step (``device_step_ms``).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

from benchmark import arith

STEP_SPAN = "benchmark.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    """The reduced profile of ``steps`` train steps; times in microseconds
    inside, seconds or milliseconds out."""

    def __init__(self, events: list, steps: int, timeline: list | None = None):
        self.steps = steps
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.host = host
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        spans = [e for e in host if e["name"] == STEP_SPAN]
        if len(spans) != steps:
            raise RuntimeError(f"the profile holds {len(spans)} step spans, not {steps}")
        start = min(e["ts"] for e in spans)
        end = max(max(e["ts"] + e["dur"] for e in spans),
                  max((e["ts"] + e["dur"] for e in self.device), default=start))
        self.start, self.end = start, end
        self.profiled_s = (end - start) / 1e6
        self.enclosing = _enclosing(host, [launches.get(e.get("args", {}).get("correlation"))
                                           for e in self.device])
        intervals = [(e["ts"], e["ts"] + e["dur"]) for e in self.device]
        self.busy_us = arith.union_length(
            [(max(s, start), min(t, end)) for s, t in intervals if t > start and s < end])
        self.window_us = end - start
        dev = [(e["ts"], e["ts"] + e["dur"]) for e in timeline or []
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        if dev:
            self.busy_us = arith.union_length(dev)
            self.window_us = max(t for _, t in dev) - min(s for s, _ in dev)

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    def device_ms(self, under=None) -> float:
        """Device time a step, of every device op or of those launched under
        a host op named in ``under`` (a name also matches the autograd
        engine's ``…: <name>`` wrapper)."""
        total = 0.0
        for e, names in zip(self.device, self.enclosing):
            if under is None or _matches(names, under):
                total += e["dur"]
        return total / 1e3 / self.steps

    def host_op_count(self, name: str) -> float:
        """Calls a step of the host op ``name`` (exact name)."""
        return sum(1 for e in self.host if e["name"] == name) / self.steps

    def kernels_per_step(self) -> float:
        return sum(1 for e in self.device if e["cat"] == "kernel") / self.steps

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle stretches summed
        by the innermost host op that launched the device op ending each,
        in seconds over the profiled steps."""
        by_op = defaultdict(float)
        for e in self.device:
            by_op[e["name"][:160]] += e["dur"] / 1e6
        order = sorted(range(len(self.device)), key=lambda i: self.device[i]["ts"])
        starts = [self.device[i]["ts"] for i in order]
        intervals = [(e["ts"], e["ts"] + e["dur"]) for e in self.device]
        by_gap = defaultdict(float)
        for s, t in arith.gaps(intervals, self.start, self.end):
            k = bisect.bisect_left(starts, t)
            names = self.enclosing[order[k]] if k < len(order) else []
            label = names[-1] if names else ("end of stretch" if k >= len(order) else "no host op")
            by_gap[label[:160]] += (t - s) / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_gap)}


def _matches(names, under) -> bool:
    return any(n == u or n.endswith(": " + u) for n in names for u in under)


def _enclosing(host: list, launches: list) -> list:
    """For each launch event (or None), the names of the host ops open on its
    thread at its start, outermost first. Host ops of a thread nest."""
    by_tid = defaultdict(list)
    for e in host:
        by_tid[e["tid"]].append(e)
    queries = defaultdict(list)
    for i, e in enumerate(launches):
        if e is not None:
            queries[e["tid"]].append((e["ts"], i))
    out = [[] for _ in launches]
    for tid, qs in queries.items():
        ops = sorted(by_tid.get(tid, []), key=lambda e: (e["ts"], -e["dur"]))
        stack, j = [], 0
        for ts, i in sorted(qs):
            while j < len(ops) and ops[j]["ts"] <= ts:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < ops[j]["ts"]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
                stack.pop()
            out[i] = [e["name"] for e in stack if e["ts"] + e["dur"] >= ts]
    return out


def _profiled(state, pool, steps: int, device, activities, span: bool) -> list:
    """The Chrome-trace events of ``steps`` train steps after one warm-up
    step, the queue drained before the first and after the last; the trace
    goes through a file in the temporary directory, deleted after."""
    from torch.profiler import profile, record_function, schedule

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=steps, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for k in range(steps + 1):
                images, labels = pool[k % len(pool)]
                if span:
                    with record_function(STEP_SPAN if k else "benchmark.warmup"):
                        state.train_step(images, labels)
                else:
                    state.train_step(images, labels)
                if k in (0, steps) and device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _device_timeline(state, pool, steps: int, device) -> list:
    from torch.profiler import ProfilerActivity

    return _profiled(state, pool, steps, device, [ProfilerActivity.CUDA], False)


def profile_steps(state, pool, steps: int, device) -> Trace:
    """``steps`` steps with host ops and device activity, then, on the card,
    as many with device activity alone."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    events = _profiled(state, pool, steps, device, acts, True)
    timeline = _device_timeline(state, pool, steps, device) if cuda else None
    return Trace(events, steps, timeline)


def device_step_ms(state, pool, steps: int, device) -> float | None:
    """The device's busy time a train step, in ms: the union of the device
    ops' intervals over ``steps`` steps profiled with device activity alone,
    over ``steps``. The same reading as a traced run's ``busy_s`` a step.
    None off the card, where there is no device op."""
    if device.type != "cuda":
        return None
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in _device_timeline(state, pool, steps, device)
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return arith.union_length(dev) / 1e3 / steps if dev else None
