"""What the per-layer metrics' readers (metrics/<name>.py) share. Each
reader takes the traced run's context and returns a number, or None
where the run holds nothing for it to read (another kind of unit, no op
range, no peak for the card): the harness then leaves the metric out.

The context: "unit" ("step" or "frame") and "units" (how many were
traced), "trace" (trace.read's dict: busy_s, window_s, launches,
op_device_s, op_least_s), "flops_per_unit" (work.FlopCounter over one
more unit), "window_units" and "window_s" (the timed window's units and
seconds), "peak" (the card's dense bf16 FLOP/s or None), "spans"
({name: [seconds of each unit in the window]}, the benchmark's own),
"stages" (stages.read of the same trace: the program's `livecell.*`
spans, each a unit; {} for a program without them) and "counters"
(stages.window's dict over the timed window: "units", "seconds" and
"counters", the change of the program's own counters: `train_epoch`'s
steps, enqueue_s, wait_s, or the frame predictor's `run.stats`
frames, dispatch_s, wait_s, unpack_s)."""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import stages, trace


def launches(ctx: Dict, unit: str) -> Optional[float]:
    if ctx["unit"] != unit:
        return None
    return ctx["trace"]["launches"] / ctx["units"]


def device_ms(ctx: Dict, unit: str) -> Optional[float]:
    if ctx["unit"] != unit:
        return None
    return ctx["trace"]["busy_s"] * 1e3 / ctx["units"]


def idle_share(ctx: Dict, unit: str) -> Optional[float]:
    if ctx["unit"] != unit:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx: Dict, unit: str) -> Optional[float]:
    """The window's model FLOP/s over the card's peak, in %."""
    if ctx["unit"] != unit or not ctx.get("peak") \
            or not ctx.get("flops_per_unit"):
        return None
    rate = ctx["flops_per_unit"] * ctx["window_units"] / ctx["window_s"]
    return 100.0 * rate / ctx["peak"]


def _roofline(t: Dict, keys: List[str]) -> Optional[float]:
    """The least seconds of the ranges `keys` over their device seconds,
    in %; None where they ran nothing on the card."""
    keys = [k for k in keys if k in t["op_least_s"]]
    device = sum(t["op_device_s"].get(k, 0.0) for k in keys)
    if device <= 0:
        return None
    return 100.0 * sum(t["op_least_s"][k] for k in keys) / device


def kernel_roofline(ctx: Dict, unit: str) -> Optional[float]:
    """The least seconds of the ops of metrics/ops.json (K1-K6) over
    their device seconds, in %."""
    if ctx["unit"] != unit:
        return None
    ops = trace.op_list(trace.op_files()[:1])
    return _roofline(ctx["trace"],
                     [k for op in ops for k in trace.range_keys(op)])


def op_roofline(ctx: Dict, unit: str, label: str) -> Optional[float]:
    """One wrapped op's least seconds over its device seconds (its range
    and its backward node's), in %; None where no op has that label or
    the traced units did not run it."""
    if ctx["unit"] != unit:
        return None
    op = next((o for o in trace.op_list() if o["label"] == label), None)
    return None if op is None else _roofline(ctx["trace"],
                                             trace.range_keys(op))


def span_ms(ctx: Dict, name: str) -> Optional[float]:
    vals = ctx.get("spans", {}).get(name)
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)


def _stages(ctx: Dict, unit: str) -> Optional[Dict]:
    st = ctx.get("stages") or {}
    return st if ctx["unit"] == unit and st.get("unit") == unit else None


def stage_ms(ctx: Dict, unit: str, span: str) -> Optional[float]:
    """Device ms a unit charged to the program's span `livecell.<span>`
    (a backward node to its forward op's span, as stages.read charges
    it); None where the trace holds no such span."""
    st = _stages(ctx, unit)
    return None if st is None else st["device_ms"].get(stages.SPAN + span)


def syncs(ctx: Dict, unit: str) -> Optional[float]:
    """Host-blocking CUDA calls made inside a unit's span, a unit."""
    st = _stages(ctx, unit)
    return None if st is None else st["unit_syncs"]


def counter_ms(ctx: Dict, unit: str, key: str) -> Optional[float]:
    """The program's counter `key` (seconds) over the timed window, in ms
    a unit as the program counts its units (its "steps" or "frames")."""
    c = (ctx.get("counters") or {}).get("counters", {})
    n = c.get(unit + "s")
    if ctx["unit"] != unit or key not in c or not n:
        return None
    return 1e3 * c[key] / n
