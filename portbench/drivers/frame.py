"""The serving cells: a closed loop of one client sending whole frames to
livecell_tpu_torch's frame predictor (serve/stitch.py:make_frame_predictor,
its `run`: `dispatch`, then `fetch` to host detections), the next frame
sent when the last one's detections are back.

Set-up makes the weights from the seed on the card, builds the
program's serving model and predictor, draws a pool of frames with
numpy (every seed the same set of cell counts) and serves a few to
warm up. The window sends frames from the
pool in an order drawn from the seed; each request is timed from its
send to its host detections, and `dispatch` alone is timed for
dispatch_ms.serve. A sample of the window's requests, drawn from the
seed, keeps what the model produced on the timed path (its per-tile
detections, and what the model part observes inside it) beside the
answer, for the output check, which runs once the window has closed and
the program is freed (`judge`).

What belongs to the configuration's model (the program's serving model,
the reference's, what is observed inside the timed path and how it is
judged) is models/<model_type>.frame.py (spec.model_part): its
`program`, `reference`, `observed`, `check`, `control_capture` and
`NUMBERS`, `COUNTS`."""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import cuda, draws, stages, trace, weights, work
from portbench import spec as spec_mod
from portbench.reference import lowp
from portbench.reference.stitch import stitch


class Serve:
    """One seed's frames and the program's predictor over them."""

    def __init__(self, spec: Dict, seed: int, device):
        from livecell_tpu_torch.config import TileConfig

        self.spec, self.device, self.t = spec, device, spec["traffic"]
        self.part = spec_mod.model_part(spec)
        self.seeds = spec_mod.seed_streams(
            seed, ("weights", "frames", "order"))
        self.tile_cfg = TileConfig(**spec["traffic"]["tile"])
        tc = self.tile_cfg
        rng = np.random.default_rng(self.seeds["frames"])
        self.frames = [draws.tiles(
            draws.frame(rng, tc.frame_width, tc.frame_height, count),
            (tc.tile_height, tc.tile_width),
            (tc.mini_tile_height, tc.mini_tile_width), tc.tiles_per_row)
            for count in draws.pool_counts(self.t["frames"], rng)]
        self.order = np.random.default_rng(self.seeds["order"])
        self.captured: Dict[str, dict] = {}
        self.capture_next = None

    def build(self, fault=None):
        """The program's serving model with the seed's weights (kept as
        `w0` for the reference) and its frame predictor. `fault` plants
        a fault in the model (calibrate.py)."""
        from livecell_tpu_torch.serve.stitch import make_frame_predictor

        model = self.part.program(self.spec["config"], self.device)
        self.w0 = weights.make(weights.shapes_of(model),
                               weights.rules_of(self.spec),
                               self.seeds["weights"], self.device)
        model.load_state_dict(self.w0)
        if fault is not None:
            fault(model)
        forward = model.inference_forward

        def observed(images):
            det = forward(images)
            if self.capture_next is not None:
                self.capture_next["det"] = det
            return det

        model.inference_forward = observed
        self.model = model
        t = self.t
        self.run = make_frame_predictor(
            model, self.tile_cfg, score_threshold=t["score_threshold"],
            mask_threshold=t["mask_threshold"],
            max_frame_dets=t["max_frame_dets"], device=self.device)

    def observed(self):
        """The model part's observation of the timed path, which fills
        `capture_next` of a captured request."""
        return self.part.observed(self)

    def request(self, i: int, capture: bool = False):
        """Serve one frame of the pool; returns (latency s, dispatch s,
        the answer)."""
        f = int(self.order.integers(len(self.frames)))
        self.capture_next = {"frame": f} if capture else None
        t0 = time.perf_counter()
        handle = self.run.dispatch(self.frames[f])
        t1 = time.perf_counter()
        ans = self.run.fetch(handle)
        t2 = time.perf_counter()
        if capture:
            self.capture_next["answer"] = ans
            self.captured[i] = self.capture_next
        self.capture_next = None
        return t2 - t0, t1 - t0, ans

    def warm_up(self) -> int:
        """Serve the traffic's warm-up frames; returns how many failed."""
        failed = 0
        for _ in range(self.t["warmup_frames"]):
            try:
                self.request(-1)
            except RuntimeError:
                failed += 1
        return failed

    def free(self):
        self.model = self.run = None
        cuda.empty()

    # -- the output check ---------------------------------------------------
    def reference_model(self, control: bool = False):
        model = self.part.reference(self.spec["config"], self.device)
        model.load_state_dict(self.w0)
        model.eval()
        return lowp.fp8(model) if control else model

    def check(self, cap: Dict, ref, program: bool = True) -> Dict:
        """The numbers of one captured request (the part's NUMBERS), the
        reference `ref` following it; `program` False for the control,
        which has no answer and no observed calls."""
        return self.part.check(self, cap, ref, program)

    def combine(self, per: List[Dict[str, float]]) -> Dict[str, float]:
        """Over the sampled requests: the largest of each count and of
        each widest gap, the mean of the others."""
        out = {}
        for k in per[0]:
            vals = [p[k] for p in per]
            out[k] = max(vals) if k in self.part.COUNTS or \
                k.startswith("widest") else sum(vals) / len(vals)
        return out

    def control(self, f: int) -> Dict:
        """The control's numbers on frame f: the fp8 reference in the
        program's place, judged by the float32 reference as the program
        is."""
        ctl = self.reference_model(control=True)
        with torch.no_grad():
            cap = self.part.control_capture(self, ctl, f)
        del ctl
        ref = self.reference_model()
        out = self.check(cap, ref, program=False)
        del ref
        return out


def stitch_differs(s: Serve, cap: Dict, input_hw, max_dets: int) -> float:
    """Rows of the captured request's answer that differ from the
    reference's stitch of the same detections."""
    t = s.t
    want = stitch(cap["det"], s.tile_cfg, input_hw, max_dets,
                  t["score_threshold"], t["mask_threshold"],
                  t["max_frame_dets"])
    return _answer_differs(cap["answer"], want)


def _answer_differs(got, want: Dict) -> float:
    """Rows of the served answer that differ from the reference's stitch
    of the same detections (all rows where the counts differ)."""
    if len(got.scores) != len(want["scores"]):
        return float(max(len(got.scores), len(want["scores"])))
    if not len(got.scores):
        return 0.0
    rows = ((got.boxes != want["boxes"]).any(1)
            | (got.scores != want["scores"])
            | (got.masks != want["masks"]).reshape(len(got.scores), -1)
            .any(1) | (got.tile_nums != want["tile_nums"]))
    return float(rows.sum())


def run(spec: Dict, args, t_start: float, device="cuda") -> Dict:
    """One run of a serving cell: set-up, the timed window, with --trace
    1 the traced requests, then the output check. `device` is the card;
    the tests pass the CPU."""
    dev = torch.device(device)
    t = spec["traffic"]
    s = Serve(spec, args.seed, dev)
    s.build()
    failed = s.warm_up()
    cuda.sync(dev)
    setup_s = time.time() - t_start

    sample = set(np.random.default_rng(s.seeds["order"] + 1).choice(
        t["sample_from"], t["check_frames"], replace=False).tolist())
    lat, disp = [], []

    def request() -> int:
        nonlocal failed
        i = len(lat)
        try:
            dt, dd, _ = s.request(i, capture=i in sample)
        except RuntimeError:
            failed += 1
            dt = dd = float("nan")
        lat.append(dt)
        disp.append(dd)
        return 1

    with s.observed():
        win = stages.window(args.seconds, request,
                            lambda: dict(s.run.stats))
    elapsed = win["seconds"]
    ok = [x for x in lat if x == x]
    out = {"attempted": len(lat) + t["warmup_frames"], "failed": failed,
           "end_to_end": {
               "setup_s": setup_s,
               "frames_per_s": len(ok) / elapsed,
               "frame_p95_ms": 1e3 * (statistics.quantiles(
                   ok, n=20, method="inclusive")[-1] if len(ok) > 1
                   else max(ok, default=float("nan")))},
           "window": {"units": len(ok), "seconds": elapsed}}
    if args.trace:
        out["ctx"] = traced(s, t, dict(win, units=len(ok)), disp)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    s.free()
    out["compared"] = judge(s)
    return out


def judge(s: Serve) -> Dict[str, float]:
    """The numbers over the sampled requests: the largest of each count,
    the mean of the others."""
    if not s.captured:
        return dict.fromkeys(s.part.NUMBERS, float("inf"))
    ref = s.reference_model()
    out = s.combine([s.check(cap, ref) for cap in s.captured.values()])
    del ref
    cuda.empty()
    return out


def traced(s: Serve, t: Dict, win: Dict, disp: List[float]) -> Dict:
    """The traced requests, read by trace.read and by span
    (stages.read), the FLOP count of one more, and the window `win` (its
    answered frames as `units`) with the predictor's `run.stats` over
    it."""
    log = trace.OpLog()
    n = t["trace_frames"]
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_trace_{os.getpid()}.json")

    def frames_():
        for _ in range(n):
            s.request(-1)

    try:
        with trace.wrapped_ops(log):
            trace.profile(frames_, path)
            calls = list(log.calls)
            counter = work.FlopCounter()
            log.counter = counter
            with counter:
                s.request(-1)
            log.counter = None
        log.calls = calls
        summary = trace.read(path, trace.op_work(log))
        by_span = stages.read(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return {"unit": "frame", "units": n, "trace": summary,
            "flops_per_unit": counter.total, "window_units": win["units"],
            "window_s": win["seconds"],
            "peak": work.peak_flops(torch.cuda.get_device_name(0)),
            "spans": {"dispatch_s": [x for x in disp if x == x]},
            "stages": by_span, "counters": win}
