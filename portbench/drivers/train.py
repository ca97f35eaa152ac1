"""The training cells: `train_epoch` of livecell_tpu_torch over a split
resident on the card, the recipe's optimizer, a batch of the traffic's
size.

Set-up makes the weights and the split from the seed on the card,
builds the program's model and optimizer, loads the weights into it,
and drives the same objects through the first epoch: its first steps
(`check_steps`) are recorded for the output check (their losses, the
first gradient as the optimizer's state after step 1 holds it, the
parameters' change after the last of them), the rest warm the epoch's
shapes. The timed window then runs whole epochs, each a new order of
the split, and ends at the fetch of its last epoch's metrics;
`train_epoch`'s counters (steps, enqueue_s, wait_s) are read over it.
After the window (and the traced part, with --trace 1) the program's
state is freed and the reference follows the checked steps in
float32."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from portbench import compare, cuda, draws, stages, trace, weights, work
from portbench import spec as spec_mod
from portbench.reference import lowp
from portbench.reference import train as ref_train

# An epoch longer than any run: the recipes' rates are constant.
CONSTANT_LR_EPOCH = 10 ** 12


def model_dict(spec: Dict) -> Dict:
    """The configuration as the program takes it: the file's keys with
    the traffic's recipe flags over them."""
    return {**spec["config"], **spec["traffic"].get("model", {})}


def program_optimizer(model, opt: Dict):
    if opt["kind"] == "adamw":
        from livecell_tpu_torch.parallel.train_step import build_optimizer
        return build_optimizer(model, opt["lr"], opt["weight_decay"],
                               CONSTANT_LR_EPOCH)
    from livecell_tpu_torch.train.train_transfer import stage_optimizer
    return stage_optimizer(model, opt["lr"], opt["momentum"],
                           opt["weight_decay"], freeze=False,
                           clip_norm=opt.get("clip_norm", 0.0))


def _terms(m: Dict[str, np.ndarray]) -> list:
    """train_epoch's metrics, a dict a step."""
    return [{k: float(v[i]) for k, v in m.items()}
            for i in range(len(m["total_loss"]))]


class Run:
    """One seed's inputs and the program's state over them."""

    def __init__(self, spec: Dict, seed: int, device):
        t = spec["traffic"]
        self.spec, self.device = spec, device
        self.part = spec_mod.model_part(spec)
        self.seeds = spec_mod.seed_streams(
            seed, ("weights", "data", "order", "noise"))
        self.batch = t["batch"]
        cfg = model_dict(spec)
        h, w = self.part.tile_hw(cfg)
        box = t["boxes"]
        gen = torch.Generator(device=device).manual_seed(self.seeds["data"])
        self.images, self.targets = draws.train_split(
            t["tiles"], h, w, cfg["max_instances"], box["count"],
            box["min_side"], box["max_side"], gen, device)
        self.order = np.random.default_rng(self.seeds["order"])
        self.steps_per_epoch = t["tiles"] // self.batch
        self.model = None

    def epoch(self) -> np.ndarray:
        """The next epoch's [steps, batch] index matrix."""
        perm = self.order.permutation(self.images.shape[0])
        n = self.steps_per_epoch * self.batch
        return perm[:n].reshape(self.steps_per_epoch, self.batch)

    def build(self, fault=None):
        """The program's model and optimizer, the seed's weights loaded
        (kept as `w0` for the reference), and the pool and the sampling
        generator. `fault` plants a fault in the model (calibrate.py)."""
        from livecell_tpu_torch.data.device_data import DeviceDataset

        self.model = self.part.program(model_dict(self.spec), self.device)
        self.w0 = weights.make(weights.shapes_of(self.model),
                               weights.rules_of(self.spec),
                               self.seeds["weights"], self.device)
        self.model.load_state_dict(self.w0)
        self.opt = program_optimizer(self.model,
                                     self.spec["traffic"]["optimizer"])
        self.pool = DeviceDataset(self.images, self.targets,
                                  device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seeds["noise"])
        if fault is not None:
            fault(self.model)

    def plan(self, rows: np.ndarray) -> None:
        """What `check_steps` sets for the reference (the seed's weights,
        the rows and the sampling generator's state), without running the
        program: for the control alone (calibrate.py)."""
        self.build()
        self.check_rows = rows
        self.noise_state = self.gen.get_state()
        self.free()

    def train(self, rows: np.ndarray, stats=None) -> Dict[str, np.ndarray]:
        """One `train_epoch` over `rows`; `stats`, where given, takes its
        counters (steps, enqueue_s, wait_s)."""
        from livecell_tpu_torch.data.device_data import train_epoch
        return train_epoch(self.model, self.opt, self.pool, rows, self.gen,
                           stats=stats)

    def check_steps(self, rows: np.ndarray) -> Dict:
        """The first steps, recorded: {"loss", "grad", "delta"} by leaf
        (gradient norms from the optimizer's state after step 1) and
        "proposals", each step's call of the proposal stage (its inputs
        and the proposals it made), observed where the program's step
        looks the stage up."""
        self.check_rows = rows
        self.noise_state = self.gen.get_state()
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        calls = []
        with self.part.proposals_observed(calls):
            m = self.train(rows[:1])
            terms = _terms(m)
            grad = {n: float(g.norm()) for n, g in
                    zip(names, self._first_grads(params))}
            if len(rows) > 1:
                terms += _terms(self.train(rows[1:]))
        delta = {n: float((p.detach() - self.w0[n]).norm())
                 for n, p in zip(names, params)}
        return {"loss": [x["total_loss"] for x in terms],
                "terms": [{k: v for k, v in x.items() if k.startswith("loss")}
                          for x in terms],
                "grad": grad, "delta": delta, "proposals": calls}

    def _first_grads(self, params):
        """Each parameter's gradient as the optimizer took it at step 1,
        from its state (AdamW's first moment / (1 - beta1); SGD's
        momentum buffer less the weight decay); zero where the
        optimizer holds no state for it."""
        opt = self.spec["traffic"]["optimizer"]
        names = [n for n, _ in self.model.named_parameters()]
        out = []
        for n, p in zip(names, params):
            st = self.opt.state.get(p, {})
            if opt["kind"] == "adamw":
                g = st["exp_avg"] / (1.0 - 0.9) if "exp_avg" in st else None
            elif "momentum_buffer" in st:
                g = st["momentum_buffer"] - opt["weight_decay"] * self.w0[n]
            else:
                g = None
            out.append(torch.zeros_like(p) if g is None else g)
        return out

    def free(self):
        """Drop the program's state (the inputs and `w0` stay)."""
        self.model = self.opt = self.pool = None
        cuda.empty()

    def reference(self, control: bool = False, forced=None,
                  records=None) -> Dict:
        """The reference over the checked steps' batches, in float32
        (TF32 off), or in fp8 as the control; `forced` and `records` as
        reference/train.py:follow takes them."""
        with lowp.exact(), torch.device(self.device):
            model = self.part.reference(model_dict(self.spec), self.device)
            model.load_state_dict(self.w0)
            if control:
                lowp.fp8(model)
            batches = []
            for r in self.check_rows:
                idx = torch.as_tensor(r, dtype=torch.long,
                                      device=self.device)
                batches.append((self.images[idx],
                                {k: v[idx] for k, v in
                                 self.targets.items()}))
            gen = torch.Generator(device=self.device)
            gen.set_state(self.noise_state)
            out = ref_train.follow(model, self.spec["traffic"]["optimizer"],
                                   batches, gen, forced, records)
            out["anchors"] = model.anchors(self.device)
            out["ref_cfg"] = model.cfg
        del model, batches
        cuda.empty()
        return out

    def judge(self, prog: Dict, details: bool = False) -> Dict:
        """The compared numbers of the program's checked steps `prog`:
        the reference follows them on the program's proposals (the
        ranking that picks them turns on rounding at random weights),
        and those proposals are held apart, each step's against the
        reference's proposal stage on the program's own RPN outputs of
        that step (`proposals_differ`, the most rows that differ in a
        step)."""
        calls = prog["proposals"]
        sel = [{"proposals": c["out"][0], "proposal_valid": c["out"][1]}
               for c in calls]
        if len(sel) != len(self.check_rows) or any(
                s["proposals"].shape[0] != self.batch for s in sel):
            return dict.fromkeys(compare.TRAIN_NUMBERS + tuple(
                f"first_{k}_gap" for k in prog["terms"][0]) + (
                "proposals_differ",), float("inf"))
        records = []
        ref = self.reference(forced=sel, records=records)
        out = compare.train_numbers(prog, ref, details)
        out["proposals_differ"] = max(
            self.part.proposals_differ(c, r, ref)
            for c, r in zip(calls, records))
        return out

    def control(self, details: bool = False) -> Dict:
        """The control's numbers: the reference in fp8 in the program's
        place, judged as `judge` judges the program (without the stage
        check, which reads no program)."""
        records = []
        ctl = self.reference(control=True, records=records)
        sel = [{k: r[k] for k in ("proposals", "proposal_valid")}
               for r in records]
        ref = self.reference(forced=sel)
        return compare.train_numbers(ctl, ref, details)


def run(spec: Dict, args, t_start: float, device="cuda") -> Dict:
    """One run of a training cell: set-up, the checked steps, the timed
    window, with --trace 1 the traced steps, then the output check.
    `device` is the card; the tests pass the CPU."""
    dev = torch.device(device)
    t = spec["traffic"]
    r = Run(spec, args.seed, dev)
    r.build()
    first = r.epoch()
    prog = r.check_steps(first[:t["check_steps"]])
    r.train(first[t["check_steps"]:])
    cuda.sync(dev)
    setup_s = time.time() - t_start

    failed = 0
    stats: Dict[str, float] = {}

    def epoch() -> int:
        nonlocal failed
        m = r.train(r.epoch(), stats)
        failed += int((~np.isfinite(m["total_loss"])).sum())
        return len(m["total_loss"])

    win = stages.window(args.seconds, epoch, lambda: dict(stats))
    steps, elapsed = win["units"], win["seconds"]

    out = {"attempted": steps, "failed": failed,
           "end_to_end": {"setup_s": setup_s,
                          "train_img_per_s": steps * r.batch / elapsed},
           "window": {"units": steps, "seconds": elapsed}}
    if args.trace:
        out["ctx"] = traced(r, t, win)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    r.free()
    out["compared"] = r.judge(prog)
    return out


def traced(r: Run, t: Dict, win: Dict) -> Dict:
    """The traced steps, read by trace.read and by span (stages.read),
    the FLOP count of one more step, and the window `win` with
    `train_epoch`'s counters over it."""
    log = trace.OpLog()
    n = t["trace_steps"]
    rows = r.epoch()[:n]
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_trace_{os.getpid()}.json")
    try:
        with trace.wrapped_ops(log):
            trace.profile(lambda: r.train(rows), path)
            calls = list(log.calls)
            counter = work.FlopCounter()
            log.counter = counter
            with counter:
                r.train(r.epoch()[:1])
            log.counter = None
        log.calls = calls
        summary = trace.read(path, trace.op_work(log))
        by_span = stages.read(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return {"unit": "step", "units": n, "trace": summary,
            "flops_per_unit": counter.total, "window_units": win["units"],
            "window_s": win["seconds"],
            "peak": work.peak_flops(torch.cuda.get_device_name(0)),
            "stages": by_span, "counters": win}
