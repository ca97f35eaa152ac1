"""The benchmark of livecell_tpu_torch on an NVIDIA H100.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (its configuration, traffic mix, the
traffic's driver, the model's part under it and the metrics, each found
by name under portbench/: spec.py), checks that what the timed
path produced agrees with the plain reference, prints each number
compared beside its limit as the last lines of standard error, and as
the last line of standard output one JSON object: correct, attempted,
failed, metrics (the end-to-end ones, or with --trace 1 the per-layer
ones), device, breakdown (--trace 1), compared. Exits non-zero, printing
no result, without a CUDA card, and if JAX or the JAX package was
loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
# Caches at fixed paths inside the checkout: only a cell's first run in
# a checkout builds or compiles. The port's CUDA libraries live in
# livecell_tpu_torch/build/ (ops/_build.py).
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "livecell_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (livecell_tpu_torch is not livecell_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def main(argv=None, device=None, spec=None) -> int:
    """The command. The tests pass `device` "cpu" and a `spec` of their
    own (spec.load's dict) to drive a run without a card; without them
    a run takes the cell of BENCHMARK.json and needs CUDA cards."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import spec as spec_mod

    spec = spec or spec_mod.load(args.workload)
    chips = spec["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None and found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    driver = spec_mod.driver(spec)
    out = driver.run(spec, args, T_START, device=device or "cuda")

    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3

    from portbench import compare, trace

    units = {m["name"]: m["unit"] for m in
             spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    if args.trace:
        ctx = out["ctx"]
        for m in spec["per_layer"]:
            v = trace.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": units[m["name"]]}
    limits = spec["limits"]
    numbers = out["compared"]
    correct = compare.judge(numbers, limits) and out["failed"] == 0
    device = {"platform": "gpu" if device is None else "cpu",
              "kind": torch.cuda.get_device_name(0) if device is None
              else "cpu", "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        t = out["ctx"]["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["compared"] = {k: {"value": numbers.get(k, float("inf")),
                              "limit": lim} for k, lim in limits.items()}
    print(f"portbench: card {card()}; window {out['window']}; "
          f"end-to-end {out['end_to_end']}; memory_peak_bytes "
          f"{out['memory_peak_bytes']}", file=sys.stderr)
    print(f"portbench: all readings {numbers}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
