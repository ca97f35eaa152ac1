"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: livecell_tpu_torch is not livecell_tpu), the
reference imports nothing of the port either, and no file names the JAX
package's benchmark (its script and its BENCH_ records)."""

import ast
import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "livecell_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in
                 p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports(path):
    tops = top_level_imports(path)
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.relative_to(ROOT).parts:
        assert "livecell_tpu_torch" not in tops, path
    text = path.read_text()
    for name in ("bench" + ".py", "BENCH" + "_r"):
        assert name not in text, (path, name)


def test_wrapped_ops_are_the_ports():
    ops = json.loads((ROOT / "metrics" / "ops.json").read_text())["ops"]
    for op in ops:
        for at in op["at"]:
            assert at.split(":")[0].split(".")[0] == "livecell_tpu_torch"


def test_loaded_modules_check(monkeypatch):
    from portbench import run

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "livecell_tpu_torch_extra",
                        types.ModuleType("livecell_tpu_torch_extra"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "livecell_tpu.models",
                        types.ModuleType("livecell_tpu.models"))
    assert run.loaded_forbidden() == ["livecell_tpu"]
