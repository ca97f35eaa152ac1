"""The traced part of a `--trace 1` run, after the timed window: a few
steps or requests under torch.profiler (CPU and CUDA activities, no
Python stacks), read into the numbers the per-layer metrics take, and
one more under the FLOP counter. The trace file is deleted once read.

During the traced part only, the port's kernel ops named in
metrics/ops.json and in each metrics/ops/*.json are wrapped where the
models look them up: each call runs under a `record_function` range of
its own and records its arguments, so its device time (the kernels
launched in its range, or in its backward node's) and the work its
algorithm needs (work.py, or a function in a file of its own that the op
names) are read whatever implements it."""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

from portbench import spec, work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT = "portbench.units"
OP = "portbench.op:"


def op_files() -> List[Path]:
    """metrics/ops.json, then each metrics/ops/*.json in sorted order."""
    metrics = spec.HERE / "metrics"
    return [metrics / "ops.json"] + sorted((metrics / "ops").glob("*.json"))


def op_list(files=None) -> List[Dict]:
    """The ops of `files` (default: op_files()), each {"label", "work",
    "at", optionally "backward"}."""
    ops = []
    for path in op_files() if files is None else files:
        ops += json.loads(path.read_text())["ops"]
    return ops


@functools.lru_cache(maxsize=None)
def work_rule(name: str) -> Callable:
    """An op's work function: work.WORK[name], or, for a name
    "<file under portbench/>.py:<function>", that function of that file
    (loaded by its path, as spec.load_module loads a model's part)."""
    if name in work.WORK:
        return work.WORK[name]
    file, _, fn = name.rpartition(":")
    if not file.endswith(".py") or ".." in file.split("/"):
        raise ValueError(f"work {name!r}: neither a key of work.WORK nor "
                         f"'<file under portbench/>.py:<function>'")
    folder, _, stem = file.removesuffix(".py").rpartition("/")
    return getattr(spec.load_module(folder, stem), fn)


def range_keys(op: Dict) -> List[str]:
    """The trace ranges an op's device time is read from: its own and,
    where it has one, its backward node's."""
    return [OP + op["label"]] + ([op["backward"]] if op.get("backward")
                                 else [])


class OpLog:
    """The wrapped ops' calls: (label, work of the call) as recorded, and
    the FLOP counter to charge, when one is active."""

    def __init__(self):
        self.calls: List[tuple] = []
        self.counter = None


@contextlib.contextmanager
def wrapped_ops(log: OpLog):
    """Wrap each op of metrics/ops.json where the models look it up."""
    saved = []
    for op in op_list():
        for at in op["at"]:
            mod_name, attr = at.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, op, log))
    try:
        yield log
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _detached(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return x


def _wrap(fn: Callable, op: Dict, log: OpLog) -> Callable:
    label, rule = op["label"], work_rule(op["work"])

    def run(*args, **kwargs):
        with torch.profiler.record_function(OP + label):
            out = fn(*args, **kwargs)
        grads = isinstance(out, torch.Tensor) and out.requires_grad
        # Shapes and boxes only: the work is counted after the trace.
        log.calls.append((label, _detached(args), kwargs, grads))
        if log.counter is not None:
            w = rule(args, kwargs)
            log.counter.add(w["fwd"][1] + (w["bwd"][1] if grads else 0.0))
        return out

    return run


def op_work(log: OpLog) -> Dict[str, Dict[str, float]]:
    """{range label: {"least_s"}} of the recorded calls: the forward
    under the op's label, the backward under its backward node's."""
    ops = {o["label"]: o for o in op_list()}
    least = collections.defaultdict(float)
    for label, args, kwargs, grads in log.calls:
        w = work_rule(ops[label]["work"])(args, kwargs)
        least[OP + label] += work.least_seconds(*w["fwd"])
        if grads and ops[label].get("backward"):
            least[ops[label]["backward"]] += work.least_seconds(*w["bwd"])
    return dict(least)


def profile(fn: Callable[[], object], path: str) -> None:
    """Run `fn` (the traced units) under torch.profiler into `path`,
    after a warm-up step the profiler discards (a bare session can lose
    its first launches on the H100)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(64):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)
        prof.step()
        with torch.profiler.record_function(UNIT):
            fn()
        torch.cuda.synchronize()


def _kind(name: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    base = "".join(out).replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].strip()
    return re.sub(r"[.\d]+$", "", base) or name


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(path: str, least: Dict[str, float]) -> Dict:
    """The traced window's numbers: launches, busy and window seconds,
    device seconds and least seconds of each wrapped op's ranges, the
    top device ops and the longest idle gaps by what the host ran."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    unit = [e for e in events if e.get("ph") == "X" and e["name"] == UNIT]
    if not unit:
        raise ValueError("the trace holds no traced units")
    start = unit[0]["ts"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and e["ts"] >= start]
    if not dev:
        raise ValueError("the trace holds no device events: was it taken "
                         "on a card?")
    end = max(max(e["ts"] + e["dur"] for e in dev),
              unit[0]["ts"] + unit[0]["dur"])
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)

    # Ranges a device event is charged to, by its launch's thread.
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("user_annotation",
                                                      "cpu_op"):
            continue
        name = e["name"]
        label = None
        if name.startswith(OP):
            label = name
        else:
            for key in least:
                if not key.startswith(OP) and name.endswith(key):
                    label = key
        if label is not None:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], label))
    for v in ranges.values():
        v.sort()
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    op_us = collections.defaultdict(float)
    for e in dev:
        run = launch.get(e.get("args", {}).get("correlation"))
        if run is None:
            continue
        rs = ranges.get(run["tid"], [])
        i = bisect.bisect_right(rs, (run["ts"], float("inf"), "")) - 1
        while i >= 0:
            s, t, label = rs[i]
            if s <= run["ts"] <= t:
                op_us[label] += e["dur"]
                break
            i -= 1
    by_kind = collections.Counter()
    for e in dev:
        by_kind[_kind(e["name"])] += e["dur"] / 1e6

    # Idle gaps, named by the innermost host op running at their middle
    # on the thread that ran the traced units.
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and e.get("tid") == unit[0]["tid"])
    host_starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [(start, start)] + [tuple(x) for x in busy] + [(end, end)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "host: Python between torch ops"
        # The innermost op covering `mid` starts last among those that
        # cover it.
        i = bisect.bisect_right(host_starts, mid) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += (b - a) / 1e6
    return {
        "busy_s": busy_us / 1e6, "window_s": (end - start) / 1e6,
        "launches": sum(e.get("cat") == "kernel" for e in dev),
        "op_device_s": {k: v / 1e6 for k, v in op_us.items()},
        "op_least_s": least,
        "device_ops": [[k, v] for k, v in by_kind.most_common(10)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(10)],
    }


def load_reader(name: str):
    """metrics/<name>.py's `read`."""
    return spec.load_module("metrics", name).read
