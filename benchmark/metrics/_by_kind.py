"""What the readers of one kind of attention call share (``stream_*`` read
the kind "streaming", ``rect_*`` the kind "rect"): the configuration's calls
of that kind under the mix's attention mode, the one list of autograd
Functions they name, the device time a step under those Functions and the
calls' roofline share of it."""

from benchmark import arith
from benchmark.harness import attention_of


def calls_of(ctx, kind: str) -> list[dict]:
    att = attention_of(ctx.cfg, ctx.mix)
    return [c for c in (att or {}).get("calls", []) if c["kind"] == kind]


def functions_of(calls: list[dict], kind: str) -> list[str]:
    """The Functions every call of the kind names: one list a kind, since a
    profile tells the calls of one Function apart by nothing but count."""
    lists = {tuple(c["functions"]) for c in calls}
    if len(lists) != 1:
        raise RuntimeError(f"the {kind!r} calls name {len(lists)} lists of Functions, not one")
    return list(lists.pop())


def device_ms(ctx, kind: str) -> float | None:
    """Device time a step of the kernels launched under the kind's Functions
    and their backward nodes, copies inside them included; None where the
    configuration has no such call or the profile holds none."""
    calls = calls_of(ctx, kind)
    if not calls:
        return None
    ms = ctx.trace.device_ms(functions_of(calls, kind))
    return ms if ms > 0 else None


def roofline_pct(ctx, kind: str) -> float | None:
    """The kind's calls' least time a step (``arith.call_bounds``, forward
    and backward, each ``count`` times) over ``device_ms``, in %. A profiled
    step must hold each Function as many times as the kind's counts sum to;
    none at all leaves the metric out (the op left the path)."""
    calls = calls_of(ctx, kind)
    if not calls:
        return None
    functions = functions_of(calls, kind)
    ms = ctx.trace.device_ms(functions)
    counts = [ctx.trace.host_op_count(name) for name in functions]
    if ms <= 0 or not any(counts):
        return None
    want = sum(c["count"] for c in calls)
    if any(n != want for n in counts):
        raise RuntimeError(f"a profiled step holds {counts} calls of {functions}, "
                           f"not {want} each")
    sched = ctx.cfg["sinkhorn"]
    bound = arith.step_attention_bound_ms(calls, ctx.mix["attention"] == "sinkhorn",
                                          sched["iters"], sched["final_row_norm"])
    return 100.0 * bound / ms
