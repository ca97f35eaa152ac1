"""Summarize a torch.profiler trace's device time (counterpart of
scripts/trace_summary.py).

Reads the newest `trace_*.json` Chrome trace that utils/profiling.trace
wrote under the directory given (or the file given) and sums the device
events, the CUDA kernels, memcpys and memsets, by bucket. Used with
tools/profile_step.py's and tools/profile_transfer.py's --trace output
to decide what to optimize.

    python -m livecell_tpu_torch.tools.trace_summary outputs/xprof \\
        [--steps 3] [--top 25]

JAX's script reads the 'XLA Ops' thread of an xprof trace; this one
reads the events of categories kernel, gpu_memcpy and gpu_memset. It
leaves out the `gpu_user_annotation` ranges, which span kernels already
counted. Its four tables are JAX's:

  * by op kind: the kernel's name without its template arguments, its
    parameters and its trailing digits, as JAX strips HLO suffixes;
  * by source line: the innermost Python frame outside torch (and not
    torch's `nn.Module:` annotation) around the kernel's launch, from a
    trace taken with `with_stack=True`, else "?" (JAX prints "?" where
    xprof has no source); a backward's kernels are launched from
    autograd's own thread, which has no Python frame: "?";
  * by torch op (JAX: "by jax op"): the aten op that launched the
    kernel, linked through the trace's `External id`, else "?";
  * top individual kernels.

A GPU stream can sit idle where a TPU runs its ops back to back, so the
header adds the device window (first device event's start to the last
one's end), the busy time (the union of the device intervals) and the
idle share of the window. `summarize` returns these numbers, `main`
prints them; both read a file and touch no device. `summarize_call`
traces one call first.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(path: str) -> str:
    """`path` itself if it is a file, else the newest trace_*.json under
    it."""
    if os.path.isfile(path):
        return path
    paths = glob.glob(os.path.join(path, "**", "trace_*.json"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no trace_*.json under {path}")
    return max(paths, key=os.path.getmtime)


def _strip_templates(name: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def kernel_kind(name: str) -> str:
    """`void ns::foo_kernel<...>(args)` -> `ns::foo_kernel`; trailing
    digits and dots go, as JAX strips `fusion.12` to `fusion`."""
    base = _strip_templates(name).replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].strip()
    return re.sub(r"[.\d]+$", "", base) or name


def _is_user_frame(name: str) -> bool:
    return not (name.startswith(("torch/", "<built-in", "<frozen",
                                 "nn.Module:"))
                or "site-packages/" in name or "/torch/" in name)


class _Frames:
    """A thread's python_function events, to find the innermost user
    frame enclosing a time."""

    def __init__(self, events: List[dict]):
        events = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in events]
        self.events = events
        self.by_id = {e["args"].get("Python id"): e for e in events}

    def source(self, ts: float) -> str:
        i = bisect.bisect_right(self.starts, ts) - 1
        e = self.events[i] if i >= 0 else None
        while e is not None and not (e["ts"] <= ts <= e["ts"] + e["dur"]
                                     and _is_user_frame(e["name"])):
            e = self.by_id.get(e["args"].get("Python parent id"))
        return e["name"] if e is not None else "?"


def _union_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def summarize(path: str, steps: int = 3, top: int = 25) -> Dict:
    """The device time of the trace at `path` (a file, or the newest
    trace_*.json under a directory): totals in ms, ms per step over
    `steps`, and the four tables as [name, µs] rows (the top kernels
    [name, µs, source]), each cut to `top` rows. Raises on a trace
    without device events."""
    path = newest_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError(f"{path} holds no device events (kernel, memcpy, "
                         f"memset): was it traced on a card?")
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    frames_of = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function":
            frames_of[(e["pid"], e["tid"])].append(e)
    frames = {k: _Frames(v) for k, v in frames_of.items()}

    def source(e: dict) -> str:
        run = launch.get(e.get("args", {}).get("correlation"))
        if run is None or (run["pid"], run["tid"]) not in frames:
            return "?"
        return frames[(run["pid"], run["tid"])].source(run["ts"])

    total = sum(e["dur"] for e in dev)
    by_kind, by_name = collections.Counter(), collections.Counter()
    by_source, by_op = collections.Counter(), collections.Counter()
    name_source: Dict[str, str] = {}
    for e in dev:
        src = source(e)
        by_name[e["name"]] += e["dur"]
        by_kind[kernel_kind(e["name"])] += e["dur"]
        by_source[src] += e["dur"]
        by_op[ops.get(e.get("args", {}).get("External id"), "?")] += e["dur"]
        name_source.setdefault(e["name"], src)
    start = min(e["ts"] for e in dev)
    end = max(e["ts"] + e["dur"] for e in dev)
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    window = end - start
    return {
        "path": path, "steps": steps,
        "device_total_ms": total / 1e3,
        "device_ms_per_step": total / steps / 1e3,
        "window_ms": window / 1e3, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "launches": sum(e["cat"] == "kernel" for e in dev),
        "device_events": len(dev),
        "by_kind": [[k, v] for k, v in by_kind.most_common(top)],
        "by_source": [[k, v] for k, v in by_source.most_common(top)],
        "by_op": [[k, v] for k, v in by_op.most_common(top)],
        "top": [[k, v, name_source[k]] for k, v in by_name.most_common(top)],
    }


def summarize_call(fn: Callable[[], object]) -> Dict:
    """`summarize` of one call of `fn` traced by utils/profiling.trace
    into a temporary directory (on a card: without one the trace holds
    no device event), with the call's wall time `wall_ms`: the host
    clock from the call to the card's synchronize."""
    from livecell_tpu_torch.utils.profiling import sync, trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        return dict(summarize(tmp, steps=1), wall_ms=wall)


def print_summary(s: Dict) -> None:
    """`s` (summarize's dict) in JAX's layout, source paths relative to
    the working directory."""
    n, total = s["steps"], s["device_total_ms"] * 1e3
    root = os.getcwd().rstrip("/") + "/"
    print(s["path"])
    print(f"Device total: {total / 1e3:.2f} ms "
          f"({total / n / 1e3:.2f} ms/step over {n} steps)")
    print(f"Window {s['window_ms']:.2f} ms, busy {s['busy_ms']:.2f} ms, "
          f"idle {100 * s['idle_share']:.1f}%, {s['launches']} kernel "
          f"launches\n")

    def table(title, rows, width=None):
        print(f"== {title} ==")
        for k, v, *_ in rows:
            print(f"{v / n / 1e3:8.3f} ms/step  {100 * v / total:5.1f}%  "
                  f"{k[:width] if width else k}")

    table("by op kind", s["by_kind"])
    print()
    table("by source line", s["by_source"])
    print()
    table("by torch op", s["by_op"], 80)
    print("\n== top individual ops ==")
    for k, v, src in s["top"]:
        print(f"{v / n / 1e3:8.3f} ms/step  {100 * v / total:5.1f}%  "
              f"{k[:40]:40s} {src.replace(root, '')}")


def main(argv=None) -> Dict:
    """Prints the summary; returns summarize's dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace_dir")
    parser.add_argument("--steps", type=int, default=3,
                        help="steps captured inside the trace context")
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args(argv)
    s = summarize(args.trace_dir, args.steps, args.top)
    print_summary(s)
    return s


if __name__ == "__main__":
    main()
