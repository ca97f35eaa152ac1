"""The PyTorch port stands alone: no module of livecell_tpu_torch/ and
not chip_smoke.py, cli_seed_spread.py, train_step_ab.py or
quality_run.py imports JAX, its libraries, the JAX package or the test
helpers under tests/, and none imports PIL, matplotlib, gradio,
requests or tqdm when it is imported (the card's machine has none of
them; the drawing and serving ones are imported inside the functions
that draw or serve, and the downloader takes urllib)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# The port and its scripts import nothing of the tests either: they keep
# their own copy of what they need.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "livecell_tpu", "tests")
# Not on the card's machine: imported only inside functions.
NOT_ON_CARD = ("PIL", "matplotlib", "gradio", "requests", "tqdm")
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "livecell_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "cli_seed_spread.py", "train_step_ab.py",
    "quality_run.py"]


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
    for rel in ("ops/cuda_match.py", "parallel/train_step.py",
                "data/device_data.py", "train/checkpoint.py",
                "ops/cuda_ms_roi_align.py", "models/transfer.py",
                "models/torch_import.py", "train/train_transfer.py",
                "data/coco.py", "data/png.py", "data/dataset.py",
                "data/tiling.py", "data/validate.py", "train/metrics.py",
                "train/coco_eval.py", "native/__init__.py",
                "utils/prefetch.py", "serve/pipeline.py", "serve/render.py",
                "serve/visualize.py", "serve/explain.py", "serve/app.py",
                "serve/stitch.py", "parallel/mesh.py", "data/multihost.py",
                "utils/flops.py", "utils/profiling.py", "data/download.py",
                "data/dvc.py", "tools/synth_splits.py", "tools/gt_bound.py",
                "tools/eval_ckpt.py", "tools/oracle_probe.py",
                "tools/quality_matrix.py", "tools/dense_sweep.py",
                "tools/trace_summary.py", "tools/profile_step.py",
                "tools/profile_transfer.py", "tools/roofline.py",
                "tools/bench_serve.py", "tools/bench_transfer_nms.py",
                "tools/check_torch_import.py", "tools/bench_conv1.py",
                "tools/bench_roi_blocks.py", "tools/bench_nms.py",
                "tools/steps.py", "tools/run_real_livecell.py",
                "data/tiff.py"):
        assert "livecell_tpu_torch/" + rel in FILES
    assert len(FILES) >= 56


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    bad = [m for m in imported_modules(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def module_level_imports(path: Path):
    """Modules imported when the file is imported: at its top level, not
    inside a function or a class body's methods."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(sub, ast.Import):
                yield from (a.name for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                yield sub.module


def test_no_module_level_pil_import(tmp_path):
    bad = {rel: m for rel in FILES for m in module_level_imports(ROOT / rel)
           if m.split(".")[0] in NOT_ON_CARD}
    assert not bad, bad
    p = tmp_path / "m.py"
    p.write_text("import numpy\ntry:\n    from PIL import Image\n"
                 "except ImportError:\n    pass\n"
                 "import matplotlib.pyplot as plt\n"
                 "def f():\n    import PIL.ImageDraw\n    import gradio\n")
    assert list(module_level_imports(p)) == ["numpy", "PIL",
                                             "matplotlib.pyplot"]


def test_scanner_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom livecell_tpu.ops import nms\n"
                 "def f():\n    import jax.numpy as jnp\n"
                 "    return __import__('flax')\n")
    mods = [m.split(".")[0] for m in imported_modules(p)]
    assert [m for m in mods if m in FORBIDDEN] == [
        "livecell_tpu", "jax", "flax"]
