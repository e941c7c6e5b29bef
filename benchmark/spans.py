"""The port's step spans as a traced run reads them, and the card's state
beside the traced stretch.

A traced stretch runs ``TrainState.train_step`` with a ``StepTracer`` (the
port's ``train/tracing.py``) started before it and drained after it: one
record a step, its boundaries ``begin``, ``forward_end``, ``backward_end``
and ``optimizer_end`` on the host's clock and on the device's (mapped onto
the host's between two anchors), the lead at each (device minus host: how
far the host ran ahead of the device) and the phases ``forward``,
``backward`` and ``optimizer`` between them. The readers
``metrics/forward_ms.py``, ``metrics/backward_ms.py`` and
``metrics/host_lead_ms_p5.py`` take the records from ``ctx.spans``;
``log_line`` gives the rest in one line.
"""

from __future__ import annotations

import statistics
import subprocess

from benchmark import arith

# the stretch's first steps, left out of the leads: after the opening
# synchronise the launch queue is still filling
SKIP_STEPS = 5

QUERY = ("clocks.sm", "clocks.max.sm", "power.draw", "power.limit", "temperature.gpu")
# the active clock-event (throttle) reasons, under the field name of newer
# nvidia-smi versions and the older one
REASON_FIELDS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
REASON_BITS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting", 0x4: "sw_power_cap",
               0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal_slowdown",
               0x40: "hw_thermal_slowdown", 0x80: "hw_power_brake_slowdown",
               0x100: "display_clock_setting"}


def records_of(ctx) -> list:
    """The drained records a reader reads; none where the run traced no
    spans."""
    return getattr(ctx, "spans", None) or []


def phase_ms(records: list, phase: str, clock: str = "device_ms") -> list[float]:
    """Each step's duration of ``phase`` on ``clock`` (``device_ms`` or
    ``host_ms``)."""
    return [r["phases"][phase][clock] for r in records]


def leads_ms(records: list, skip: int = SKIP_STEPS, boundary: str | None = None) -> list[float]:
    """The lead at every boundary (or at ``boundary`` alone) of every step
    but the first ``skip``."""
    return [b["lead_ms"] for r in records[skip:] for name, b in r["boundaries"].items()
            if boundary in (None, name)]


def log_line(drained: dict) -> str:
    """Per phase the device and host medians, per boundary the lead's 5th
    and 50th percentiles, the drift between the anchors and the steps
    traced, in one line."""
    records = drained["records"]
    if not records:
        return f"spans: no step traced of {drained['steps']}"
    med = statistics.median
    phases = "; ".join(f"{p} device {med(phase_ms(records, p)):.4f} host "
                       f"{med(phase_ms(records, p, 'host_ms')):.4f}"
                       for p in records[0]["phases"])
    leads = "; ".join(f"{b} p5 {arith.percentile(v, 5):.4f} p50 {arith.percentile(v, 50):.4f}"
                      for b in records[0]["boundaries"]
                      if (v := leads_ms(records, boundary=b)))
    return (f"spans: ms medians {phases}; lead ms (first {SKIP_STEPS} steps left out) "
            f"{leads}; drift between the anchors {drained['drift_ms']:.4f} ms; "
            f"{len(records)} of {drained['steps']} steps traced")


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return None


def card_state(device) -> dict | None:
    """The card's SM clock and its maximum (MHz), power draw and limit (W),
    temperature (C) and active clock-event reasons, read once with
    ``nvidia-smi``; None off the card or where ``nvidia-smi`` fails."""
    if device.type != "cuda":
        return None
    import torch

    ident = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
    for field in REASON_FIELDS:
        try:
            out = subprocess.run(["nvidia-smi", f"--id={ident}",
                                  "--query-gpu=" + ",".join(QUERY + (field,)),
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if out.returncode == 0 and out.stdout.strip():
            break
    else:
        return None
    values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    if len(values) != len(QUERY) + 1:
        return None
    state = {q: _number(v) for q, v in zip(QUERY, values)}
    try:
        mask = int(values[-1], 16)
    except ValueError:
        mask = None
    state.update({field: values[-1], "reasons": None if mask is None else
                  [name for bit, name in REASON_BITS.items() if mask & bit]})
    return state
