"""Spans inside the train step: when its forward, backward and optimizer
begin and end on the host's clock and on the device's, and how far the host
runs ahead of the device at each of those points.

While ``TrainState.tracer`` holds a ``StepTracer``, ``train_step`` marks four
boundaries a step: ``begin`` (after ``model.train()``), ``forward_end``
(after the loss), ``backward_end`` (after ``zero_grad`` and
``loss.backward()``) and ``optimizer_end`` (after ``optimizer.step()``). A
mark reads the host's clock, then records a CUDA event on the current
stream. The phases ``forward``, ``backward`` and ``optimizer`` are the
intervals between them; the record of a step is their parent span.

Device times come onto the host's clock through two anchors: ``start()`` and
``drain()`` each synchronise, record an event on the idle device and read
the host's clock right after, so that event runs within microseconds of the
reading. An event's time since the opening anchor is mapped linearly between
the two anchors' host times, which takes out the drift between the card's
timer and the host's clock (−3.4 to −4.5 ppm on an H100 80GB HBM3: 0.17 to
0.23 ms over 51 s).
``elapsed_time`` is a float32 of milliseconds, so a time past 32 s since the
opening anchor is resolved to about 4 µs; a step's own boundaries are timed
from its ``begin`` event, to about 0.5 µs.

A boundary's lead is its device time minus its host time: how far the host
ran ahead of the device there. A lead near zero means the device had caught
up and waited for the host.

Take the phase split from these events, not from a profile's host spans:
the autograd engine launches the CUDA backward from a thread of its own, so
a profile that gives each device op to the host ops open on its launching
thread puts none of the backward under a span opened in ``train_step``.

On the CPU the events are host clocks: device times equal host times and
every lead is 0.
"""

from __future__ import annotations

import time

import torch

__all__ = ["BOUNDARIES", "PHASES", "StepTracer"]

BOUNDARIES = ("begin", "forward_end", "backward_end", "optimizer_end")
PHASES = ("forward", "backward", "optimizer")
_INDEX = {b: k for k, b in enumerate(BOUNDARIES)}
_LAST = len(BOUNDARIES) - 1


class StepTracer:
    """A ring of the last ``capacity_steps`` traced steps. Its CUDA events,
    four a step, are made and recorded once here (a CUDA event is created on
    the device at its first record), so no traced step creates one; when the
    ring is full, a new step takes the oldest step's place."""

    def __init__(self, device, capacity_steps: int = 4096):
        self.device = torch.device(device)
        self.capacity = capacity_steps
        self._cuda = self.device.type == "cuda"
        n = len(BOUNDARIES) * capacity_steps
        self._host = [0] * n
        self._steps = [0] * capacity_steps
        self._events = []
        if self._cuda:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 2)]
            for e in self._events:
                e.record()
            torch.cuda.synchronize(self.device)
        self._done = 0
        self._base = 0
        self._origin = None

    def _anchor(self, k: int) -> int:
        """Synchronise, record anchor ``k`` (0 opening, 1 closing) on the idle
        device and return the host's clock right after, in ns."""
        if not self._cuda:
            return time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        self._events[-2 + k].record()
        t = time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        return t

    def start(self) -> None:
        """Empty the ring and take the opening anchor."""
        self._done = 0
        self._origin = self._anchor(0)

    def mark(self, boundary: str, step: int | None = None) -> None:
        """Mark ``boundary`` (one of ``BOUNDARIES``, in order) of the current
        step: the host's clock, then an event on the current stream.
        ``begin`` opens the step numbered ``step``; ``optimizer_end`` closes
        it."""
        t = time.perf_counter_ns()
        k = _INDEX[boundary]
        if k == 0:
            s = self._done % self.capacity
            self._base = len(BOUNDARIES) * s
            self._steps[s] = step
        self._host[self._base + k] = t
        if self._cuda:
            self._events[self._base + k].record()
        if k == _LAST:
            self._done += 1

    def drain(self) -> dict:
        """Take the closing anchor and return the ring's steps, oldest first;
        then empty the ring. A step begun and not closed is left out.

        Returns ``records``, one a step: ``step`` (its number),
        ``boundaries`` (each of ``BOUNDARIES``: ``host_ms`` and
        ``device_ms``, both on the host's clock in ms since the opening
        anchor, and ``lead_ms``, the device's minus the host's) and
        ``phases`` (each of ``PHASES``: ``host_ms`` and ``device_ms``, the
        interval between its two boundaries). Beside them ``drift_ms``, the
        closing anchor's unmapped device time minus its host time, and
        ``steps``, the steps closed since ``start()``, of which the ring
        keeps the last ``capacity``."""
        if self._origin is None:
            raise RuntimeError("StepTracer.drain() before start()")
        span_ms = (self._anchor(1) - self._origin) / 1e6
        device_span_ms = (self._events[-2].elapsed_time(self._events[-1]) if self._cuda
                          else span_ms)
        scale = span_ms / device_span_ms
        done = self._done
        records = [self._record(j % self.capacity, scale)
                   for j in range(max(0, done - self.capacity), done)]
        self._done = 0
        return {"records": records, "drift_ms": device_span_ms - span_ms, "steps": done}

    def _record(self, s: int, scale: float) -> dict:
        base = len(BOUNDARIES) * s
        host = [(t - self._origin) / 1e6 for t in self._host[base:base + len(BOUNDARIES)]]
        if self._cuda:
            ev = self._events[base:base + len(BOUNDARIES)]
            d0 = scale * self._events[-2].elapsed_time(ev[0])
            dev = [d0] + [d0 + scale * ev[0].elapsed_time(e) for e in ev[1:]]
        else:
            dev = host
        return {"step": self._steps[s],
                "boundaries": {b: {"host_ms": h, "device_ms": d, "lead_ms": d - h}
                               for b, h, d in zip(BOUNDARIES, host, dev)},
                "phases": {p: {"host_ms": host[k + 1] - host[k],
                               "device_ms": dev[k + 1] - dev[k]}
                           for k, p in enumerate(PHASES)}}
