"""What the per-layer metrics' readers (metrics/<name>.py) share. Each
reader takes the traced run's context and returns a number, or None
where the run holds nothing for it to read (another kind of unit, no op
range, no peak for the card): the harness then leaves the metric out.

The context: "unit" ("step" or "frame") and "units" (how many were
traced), "trace" (trace.read's dict: busy_s, window_s, launches,
op_device_s, op_least_s), "flops_per_unit" (work.FlopCounter over one
more unit), "window_units" and "window_s" (the timed window's units and
seconds), "peak" (the card's dense bf16 FLOP/s or None) and "spans"
({name: [seconds of each unit in the window]})."""

from __future__ import annotations

from typing import Dict, Optional


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


def kernel_roofline(ctx: Dict, unit: str) -> Optional[float]:
    """The wrapped ops' least seconds over their device seconds, in %."""
    if ctx["unit"] != unit:
        return None
    t = ctx["trace"]
    device = sum(t["op_device_s"].get(k, 0.0) for k in t["op_least_s"])
    if device <= 0:
        return None
    return 100.0 * sum(t["op_least_s"].values()) / device


def span_ms(ctx: Dict, name: str) -> Optional[float]:
    vals = ctx.get("spans", {}).get(name)
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
