"""The PyTorch port stands alone: no module of livecell_tpu_torch/ and
not chip_smoke.py imports JAX, its libraries or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "livecell_tpu")
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "livecell_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_scan_covers_the_package():
    assert "livecell_tpu_torch/ops/cuda_roi_align.py" in FILES
    assert len(FILES) >= 20


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    bad = [m for m in imported_modules(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom livecell_tpu.ops import nms\n"
                 "def f():\n    import jax.numpy as jnp\n"
                 "    return __import__('flax')\n")
    mods = [m.split(".")[0] for m in imported_modules(p)]
    assert [m for m in mods if m in FORBIDDEN] == [
        "livecell_tpu", "jax", "flax"]
