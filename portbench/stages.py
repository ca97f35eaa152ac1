"""The program's stage spans in a traced run's Chrome trace: where the
card's time, the host's time, the launches, the host-blocking CUDA
calls and the card's idle time of a traced unit go, by the
`livecell.*` spans of livecell_tpu_torch (utils/profiling.span).

`read(path)` returns {} for a trace that holds no such span (a program
without them). Otherwise, each a unit (`livecell.step` or
`livecell.frame`, the spans counted in the trace):

  device_ms   the kernels, copies and sets of the card, each charged to
              the innermost span open, on any thread, when its launch
              was made (the CUDA runtime or driver call of its
              `correlation`); a launch inside an autograd node
              (`autograd::engine::evaluate_function: ...`) is charged to
              the stage of the forward op the node differentiates (the
              node's `Sequence number`, the forward op's on the thread
              that ran the units), or to BACKWARD_UNLINKED where that op
              lies in no stage (AccumulateGrad, the loss sum); NO_SPAN
              where no span was open (`busy_ms`: the union of their
              intervals, which trace.read's device_ms_per_* reads);
  launches    kernel launches, charged as device_ms is;
  host_ms     each span's duration, summed over its openings;
  self_ms     the same less the spans directly inside it;
  syncs       host-blocking CUDA calls (SYNC_CALLS), by the innermost
              span open when they were made; `sync_calls` by name;
              `unit_syncs` those made while a unit's span was open;
  idle_ms     the card's idle gaps in the traced window (as trace.read
              takes it), by the innermost span open at each gap's
              middle; `idle_calls` by the CUDA call running then;
              `idle_ops` the twelve largest by span and host op (as
              trace.read names a gap: the innermost torch op on the
              units' thread).

    python3 portbench/stages.py --workload <name> --seed <n> \\
        --seconds <s> [--units <k>]

runs a training or serving cell of BENCHMARK.json on the card (its
set-up, a window of `--seconds`, then `--units` traced units, as the
cell's driver does, without the output check), and prints, as one line
of standard error starting "portbench: stages", this module's reading
of the traced units and the program's own counters over the window:
`train_epoch`'s stats (steps, enqueue_s, wait_s) or the frame
predictor's `run.stats` (frames, dispatch_s, wait_s, unpack_s), with
the benchmark's own dispatch span and the requests' latency; the
window's units and seconds; and the traced units' wall seconds under
the profiler."""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import time
from typing import Dict, List, Optional

SPAN = "livecell."
UNIT_SPANS = ("livecell.step", "livecell.frame")
BACKWARD = "autograd::engine::evaluate_function: "
BACKWARD_UNLINKED = "backward (unlinked)"
NO_SPAN = "none"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaFree")
# Spans a backward node is not charged to: its forward op lay outside
# every stage of the model.
NOT_STAGES = UNIT_SPANS + ("livecell.backward",)
UNITS_RANGE = "portbench.units"
PYTHON = "host: Python between torch ops"


class _Open:
    """Ranges of a trace (X events), for the innermost one open at a
    time: the one that opened last among those open, on any thread.
    `depth` bounds how many earlier ranges are looked at (None: all)."""

    def __init__(self, ranges: List[Dict], depth: Optional[int] = None):
        self.ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ranges]
        self.depth = depth

    def at(self, ts: float) -> Optional[Dict]:
        i = bisect.bisect_right(self.starts, ts) - 1
        stop = -1 if self.depth is None else max(i - self.depth, -1)
        for k in range(i, stop, -1):
            e = self.ranges[k]
            if e["ts"] + e["dur"] >= ts:
                return e
        return None

    def name_at(self, ts: float) -> str:
        e = self.at(ts)
        return NO_SPAN if e is None else e["name"]


class _Trace:
    """A Chrome trace's spans, autograd nodes and CUDA runtime calls,
    from the start of the traced units (the benchmark's `portbench.units`
    range; the whole trace without one)."""

    def __init__(self, path: str):
        with open(path) as f:
            self.events = [e for e in json.load(f)["traceEvents"]
                           if e.get("ph") == "X"]
        window = [e for e in self.events if e["name"] == UNITS_RANGE]
        self.window = window[0] if window else None
        self.start = window[0]["ts"] if window else min(
            (e["ts"] for e in self.events), default=0.0)
        self.spans = [e for e in self.events if e["name"].startswith(SPAN)
                      and e.get("cat") in ("user_annotation", "cpu_op")]
        self.open = _Open(self.spans)
        main_tid = window[0]["tid"] if window else None
        # Forward ops -> stage by sequence number; autograd nodes, which
        # run one after another on a thread. An op records the number the
        # next autograd node will take, so ops that make no node share
        # it with the one that does, which comes last: the last op of a
        # number on the units' thread (outside the backward) is its
        # forward op.
        self.fwd_stage: Dict[int, str] = {}
        nodes = collections.defaultdict(list)
        for e in sorted(self.events, key=lambda e: e["ts"]):
            if e.get("cat") != "cpu_op":
                continue
            seq = e.get("args", {}).get("Sequence number")
            if e["name"].startswith(BACKWARD):
                nodes[e["tid"]].append(e)
            elif seq is not None and (main_tid is None
                                      or e["tid"] == main_tid):
                stage = self.open.name_at(e["ts"])
                if stage != "livecell.backward":
                    self.fwd_stage[seq] = stage
        self.nodes = {t: _Open(v, depth=1) for t, v in nodes.items()}
        # CUDA calls, of the runtime and of the driver (cuDNN and
        # cuBLASLt launch through the driver).
        self.calls = [e for e in self.events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.launch = {e["args"]["correlation"]: e for e in self.calls
                       if "correlation" in e.get("args", {})}
        self.host_ops = _Open([e for e in self.events
                               if e.get("cat") == "cpu_op" and (
                                   main_tid is None
                                   or e["tid"] == main_tid)], depth=4096)

    def node_stage(self, node: Dict) -> str:
        """The stage of the forward op an autograd node differentiates,
        or BACKWARD_UNLINKED."""
        stage = self.fwd_stage.get(node["args"].get("Sequence number"))
        return BACKWARD_UNLINKED if stage in NOT_STAGES + (None, NO_SPAN) \
            else stage

    def charged(self, ts: float, tid) -> str:
        """What a launch at `ts` on thread `tid` is charged to."""
        nodes = self.nodes.get(tid)
        node = nodes.at(ts) if nodes is not None else None
        if node is not None:
            return self.node_stage(node)
        return self.open.name_at(ts)


def backward_nodes(path: str) -> List[tuple]:
    """(autograd node, the stage it is charged to) of each node in the
    trace at `path`."""
    t = _Trace(path)
    return [(n["name"][len(BACKWARD):], t.node_stage(n))
            for o in t.nodes.values() for n in o.ranges]


def _self_us(spans: List[Dict]) -> Dict[str, float]:
    """Each span name's duration less its direct children's, summed."""
    out = collections.defaultdict(float)
    by_tid = collections.defaultdict(list)
    for e in spans:
        by_tid[e["tid"]].append(e)
    for evs in by_tid.values():
        stack: List[Dict] = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            end = e["ts"] + e["dur"]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < end:
                stack.pop()
            out[e["name"]] += e["dur"]
            if stack:
                out[stack[-1]["name"]] -= e["dur"]
            stack.append(e)
    return dict(out)


def _busy(dev: List[Dict]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(path: str) -> Dict:
    """The per-stage numbers of the trace at `path` (see the module's
    docstring), or {} where it holds no `livecell.*` span."""
    t = _Trace(path)
    unit_name = next((n for n in UNIT_SPANS
                      if any(e["name"] == n for e in t.spans)), None)
    if unit_name is None:
        return {}
    spans = [e for e in t.spans if e["ts"] >= t.start]
    n = max(sum(e["name"] == unit_name for e in spans), 1)

    dev = [e for e in t.events if e.get("cat") in DEVICE_CATS
           and e["ts"] >= t.start]
    device_us = collections.defaultdict(float)
    launches = collections.Counter()
    for e in dev:
        run = t.launch.get(e.get("args", {}).get("correlation"))
        name = NO_SPAN if run is None else t.charged(run["ts"], run["tid"])
        device_us[name] += e["dur"]
        launches[name] += e.get("cat") == "kernel"

    syncs, sync_calls = collections.Counter(), collections.Counter()
    units = _Open([e for e in spans if e["name"] == unit_name])
    unit_syncs = 0
    for e in t.calls:
        if e["name"] in SYNC_CALLS and e["ts"] >= t.start:
            syncs[t.open.name_at(e["ts"])] += 1
            sync_calls[e["name"]] += 1
            unit_syncs += units.at(e["ts"]) is not None

    # The card's idle gaps in the traced window, as trace.read takes it.
    busy = _busy(dev)
    ends = [b[1] for b in busy]
    if t.window is not None:
        ends.append(t.window["ts"] + t.window["dur"])
    end = max(ends, default=t.start)
    calls = _Open(t.calls, depth=4)
    idle_us = collections.defaultdict(float)
    idle_calls = collections.defaultdict(float)
    idle_ops = collections.defaultdict(float)
    edges = [(t.start, t.start)] + [tuple(b) for b in busy] + [(end, end)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            mid = (a + b) / 2
            span = t.open.name_at(mid)
            idle_us[span] += b - a
            idle_calls[calls.name_at(mid)] += b - a
            op = t.host_ops.at(mid)
            idle_ops[f"{span} | " + (PYTHON if op is None
                                     else op["name"])] += b - a

    host_us = collections.defaultdict(float)
    for e in spans:
        host_us[e["name"]] += e["dur"]

    def per_unit(d, scale=1e-3):
        return {k: v * scale / n for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])}

    return {"unit": unit_name[len(SPAN):], "units": n,
            "busy_ms": sum(b - a for a, b in busy) * 1e-3 / n,
            "device_ms": per_unit(device_us),
            "launches": per_unit(launches, 1.0),
            "host_ms": per_unit(host_us),
            "self_ms": per_unit(_self_us(spans)),
            "syncs": per_unit(syncs, 1.0),
            "sync_calls": per_unit(sync_calls, 1.0),
            "unit_syncs": unit_syncs / n,
            "idle_ms": per_unit(idle_us),
            "idle_calls": per_unit(idle_calls),
            "idle_ops": dict(list(per_unit(idle_ops).items())[:12])}


def line(result: Dict) -> str:
    """The one stderr line of a reading."""
    return "portbench: stages " + json.dumps(result)


# -- the window, and the command ----------------------------------------------
def window(seconds: float, unit, counters) -> Dict:
    """Units `unit()` back to back for `seconds` (each call returns how
    many units it ran): {"units", "seconds", "counters": each counter's
    change over them} (`counters()` a flat dict of numbers, read before
    the first unit and after the last, outside the timed seconds). The
    drivers time their windows by it; their traced runs' readers take
    it as ctx["counters"]."""
    before = counters()
    n, t0 = 0, time.perf_counter()
    while True:
        n += unit()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    after = counters()
    return {"units": n, "seconds": elapsed,
            "counters": {k: after[k] - before.get(k, 0) for k in after}}


def _train(spec: Dict, args, dev) -> tuple:
    from portbench.drivers import train

    r = train.Run(spec, args.seed, dev)
    r.build()
    r.train(r.epoch())
    stats: Dict[str, float] = {}

    def epoch():
        return len(r.train(r.epoch(), stats)["total_loss"])

    rows = r.epoch()[:args.units]
    return epoch, (lambda: dict(stats)), (lambda: r.train(rows))


def _frame(spec: Dict, args, dev) -> tuple:
    from portbench.drivers import frame

    s = frame.Serve(spec, args.seed, dev)
    s.build()
    s.warm_up()
    own = {"bench_dispatch_s": 0.0, "latency_s": 0.0}

    def request():
        latency, dispatch, _ = s.request(-1)
        own["bench_dispatch_s"] += dispatch
        own["latency_s"] += latency
        return 1

    def counters():
        return {**s.run.stats, **own}

    def traced():
        for _ in range(args.units):
            s.request(-1)

    return request, counters, traced


def main(argv=None) -> int:
    import argparse
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from portbench import cuda, trace
    from portbench import spec as spec_mod

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--units", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: stages needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    spec = spec_mod.load(args.workload)
    dev = torch.device("cuda")
    unit, counters, traced = {"train": _train, "frame": _frame}[
        spec["traffic"]["driver"]](spec, args, dev)
    cuda.sync(dev)
    win = window(args.seconds, unit, counters)
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_stages_{os.getpid()}.json")
    wall = {}

    def timed():
        t0 = time.perf_counter()
        traced()
        cuda.sync(dev)
        wall["traced_s"] = time.perf_counter() - t0

    try:
        with trace.wrapped_ops(trace.OpLog()):   # as the drivers trace
            trace.profile(timed, path)
        out = read(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    out.update(workload=args.workload, seed=args.seed, window=win, **wall)
    print(line(out), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
