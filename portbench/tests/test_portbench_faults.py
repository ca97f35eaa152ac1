"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (run.main on the CPU, the cells
at the CPU tests' size) and each fault a cell can have is planted in the
program; the control (the reference in fp8 in the program's place) fails
the cell's limits too. The sound run beside them comes out correct."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from portbench import calibrate, compare, run
from portbench.drivers import frame, train
from portbench.tests.tiny_specs import tiny

torch.set_num_threads(2)
TRAIN = ["custom.train.flagship.b256", "transfer.train.b16"]
SERVE = ["transfer.serve.frame"]


def result(workload, seed=2147483651):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", "0"], device="cpu",
                      spec=tiny(workload))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound(workload):
    assert result(workload)["correct"] is True


@pytest.mark.parametrize("workload", TRAIN)
def test_state_unchanged(workload, monkeypatch):
    import livecell_tpu_torch.parallel.train_step as ts

    monkeypatch.setattr(ts, "apply_update", lambda opt: None)
    assert result(workload)["correct"] is False


def _planted(monkeypatch, cls, fault):
    build = cls.build
    monkeypatch.setattr(cls, "build",
                        lambda self, fault_=None: build(self, fault=fault))


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch(workload, monkeypatch):
    _planted(monkeypatch, train.Run, calibrate.half_batch)
    assert result(workload)["correct"] is False


@pytest.mark.parametrize("fault", calibrate.SERVE_FAULTS)
def test_serving_faults(fault, monkeypatch):
    _planted(monkeypatch, frame.Serve, calibrate.FAULTS[fault])
    assert result("transfer.serve.frame")["correct"] is False


@pytest.mark.parametrize("workload", TRAIN)
def test_training_control(workload):
    sp = tiny(workload)
    r = train.Run(sp, 2147483652, torch.device("cpu"))
    r.plan(r.epoch()[:3])
    assert not compare.judge(r.control(), sp["limits"])


def test_serving_control():
    sp = tiny("transfer.serve.frame")
    s = frame.Serve(sp, 2147483653, torch.device("cpu"))
    s.build()
    s.free()
    assert not compare.judge(s.control(0), sp["limits"])
