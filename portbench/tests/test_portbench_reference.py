"""The reference against the port on the CPU at a small size, both in
float32: the training step of each model (losses, first gradients,
change after three steps, the proposal stage) and the transfer model's
frame (the RPN's outputs, proposals, both NMS calls, each detection's
box, score and mask, the stitch) agree to rounding."""

import pytest
import torch

from portbench.drivers import frame, train
from portbench.tests.tiny_specs import tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("workload", ["custom.train.flagship.b256",
                                      "transfer.train.b16"])
def test_training_step(workload):
    r = train.Run(tiny(workload), 2147483649, torch.device("cpu"))
    r.build()
    prog = r.check_steps(r.epoch()[:3])
    r.free()
    got = r.judge(prog)
    assert got["proposals_differ"] == 0
    # The first step alone: no update has yet amplified a rounding.
    assert got["median_grad_gap"] < 1e-4, got
    assert got["first_loss_gap"] < 1e-4, got
    # Within each compared number's limit, float32 against float32.
    for k, lim in r.spec["limits"].items():
        assert got[k] <= lim, (k, got[k], lim)


def test_frame():
    s = frame.Serve(tiny("transfer.serve.frame"), 2147483650,
                    torch.device("cpu"))
    s.build()
    with s.observed():
        s.request(0, capture=True)
    s.free()
    got = frame.judge(s)
    for k in s.part.COUNTS + ("unmatched_share",):
        assert got[k] == 0, (k, got)
    for k in ("rpn_gap", "mean_box_gap", "mean_score_gap", "mask_feat_gap",
              "mask_gap", "mean_mask_gap", "widest_mask_gap",
              "widest_score_gap"):
        assert got[k] < 1e-4, (k, got)
