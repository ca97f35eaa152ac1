"""The last line of a run: one JSON object with correct, attempted,
failed, metrics (the cell's end-to-end metrics, each with its unit),
device, and last `compared`, each number beside its limit; the same
numbers as the last lines of standard error."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import run
from portbench.tests.tiny_specs import tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("workload", ["transfer.train.b16",
                                      "transfer.serve.frame"])
def test_last_line(workload):
    out, err = io.StringIO(), io.StringIO()
    sp = tiny(workload)
    with redirect_stdout(out), redirect_stderr(err):
        assert run.main(["--workload", workload, "--seed", "4294967311",
                         "--seconds", "0.5", "--trace", "0"],
                        device="cpu", spec=sp) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["metrics"]) == {m["name"] for m in sp["end_to_end"]}
    for m in sp["end_to_end"]:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert list(line["compared"]) == list(sp["limits"])
    tail = err.getvalue().strip().splitlines()[-len(sp["limits"]):]
    for (k, v), text in zip(line["compared"].items(), tail):
        assert text == f"compared {k} {v['value']!r} limit {v['limit']!r}"
    assert line["attempted"] >= 1 and line["failed"] == 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert run.main(["--workload", "transfer.train.b16", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
