"""A cell's specification, found by name: its entry in BENCHMARK.json,
its configuration file, its traffic mix (`traffic/<traffic>.json`), the
limits of its output check (`limits/<workload>.json`), and the metrics
it reports; and the modules a name picks: a traffic's driver
(`drivers/<driver>.py`), a model under a driver
(`models/<model_type>.<driver>.py`) and a metric's reader
(`metrics/<metric>.py`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from types import ModuleType
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _reports(metric: Dict, workload: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", None) in e2e if "moves" in metric else True


def load(workload: str, bench_path: Path = REPO / "BENCHMARK.json") -> Dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of the cell named `workload`; raises KeyError for a
    name BENCHMARK.json does not hold."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; have "
                       f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    limits_path = HERE / "limits" / f"{workload}.json"
    return {
        "workload": cell,
        "config": json.loads((REPO / config["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(limits_path.read_text())
        if limits_path.exists() else {},
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def seed_streams(seed: int, names: Sequence[str]) -> Dict[str, int]:
    """Independent streams of a run's seed, one a name."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(names))
    return dict(zip(names, (int(x) for x in state)))


def load_module(folder: str, name: str) -> ModuleType:
    """portbench/<folder>/<name>.py, imported by its path (a name may hold
    dots, a folder slashes); raises FileNotFoundError where there is no
    such file."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder}/{name}.py under {HERE}")
    key = "portbench_" + re.sub(r"\W", "_", f"{folder}_{name}")
    mod = importlib.util.spec_from_file_location(key, path)
    out = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(out)
    return out


def driver(spec: Dict) -> ModuleType:
    """The driver the cell's traffic names: portbench.drivers.<driver>."""
    return importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")


def model_part(spec: Dict) -> ModuleType:
    """What the cell's driver needs of its configuration's model:
    models/<model_type>.<driver>.py."""
    return load_module("models", f"{spec['config']['model_type']}."
                       f"{spec['traffic']['driver']}")
