"""The port's profiling helpers (livecell_tpu_torch/utils/profiling.py) on
the CPU."""

import json

import torch

from livecell_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path))
    assert any(e.get("name") == "aten::mm" for e in events)


def test_time_fn_counts_every_call():
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x), 1, warmup=2, iters=5)
    assert len(calls) == 7
    assert set(out) == {"mean_s", "median_s", "min_s"}
    assert 0 <= out["min_s"] <= out["median_s"]


def test_device_memory_stats():
    """{} without a card, the allocator's counters in MiB with one."""
    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert stats["allocated_bytes.all.current"] >= 0
    else:
        assert stats == {}


def test_enable_nan_debug_switches_anomaly_detection():
    try:
        profiling.enable_nan_debug(True)
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()
