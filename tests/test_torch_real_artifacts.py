"""Real-artifact gates of the port (counterpart of
tests/test_real_artifacts.py): tests that run the moment genuine
torchvision weights or the real LIVECell tree are present, against the
pinned manifests in docs/manifests/. Without them the last two skip.

    LIVECELL_WEIGHTS=models/maskrcnn_resnet50_fpn_coco.pth \\
    LIVECELL_DATA=data pytest tests/test_torch_real_artifacts.py -v

(livecell_tpu_torch/tools/run_real_livecell.py runs the same gates
before training.)
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from livecell_tpu_torch.data import download
from livecell_tpu_torch.data.validate import validate_tree
from livecell_tpu_torch.tools import check_torch_import
from livecell_tpu_torch.tools import run_real_livecell as rrl

REPO = Path(__file__).resolve().parent.parent
MANIFESTS = REPO / "docs" / "manifests"


def _weights_path():
    p = os.environ.get("LIVECELL_WEIGHTS",
                       str(REPO / "models" / "maskrcnn_resnet50_fpn_coco.pth"))
    return p if os.path.exists(p) else None


def _data_root():
    p = os.environ.get("LIVECELL_DATA", str(REPO / "data"))
    return p if os.path.isdir(os.path.join(p, "annotations")) else None


def test_manifests_are_valid_json_and_match_the_port():
    for name in ("livecell_data.json", "torchvision_weights.json"):
        with open(MANIFESTS / name) as f:
            assert json.load(f), name
    wm = json.loads((MANIFESTS / "torchvision_weights.json").read_text())
    # The pin is torchvision's file-name suffix, and the runbook's.
    assert wm["sha256_prefix"] in wm["url"]
    assert (rrl.TV_URL, rrl.PIN, rrl.WEIGHTS) == (
        wm["url"], wm["sha256_prefix"], wm["local_path"])
    assert rrl.MANIFEST == MANIFESTS / "torchvision_weights.json"
    dm = json.loads((MANIFESTS / "livecell_data.json").read_text())
    assert download.ANNOTATIONS == dm["sources"]["annotations"]
    assert download.IMAGES_URL == dm["sources"]["images_zip"]


@pytest.mark.skipif(_weights_path() is None,
                    reason="genuine torchvision weights not present "
                           "(no network here); see docs/manifests/")
def test_real_weights_sha256_and_import():
    wm = json.loads((MANIFESTS / "torchvision_weights.json").read_text())
    path = _weights_path()
    digest = rrl.sha256_file(path)
    assert digest.startswith(wm["sha256_prefix"]), \
        "weight file does not match the pinned sha256 prefix"
    if wm.get("sha256_full"):
        assert digest == wm["sha256_full"]
    if torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m",
             "livecell_tpu_torch.tools.check_torch_import", "--weights",
             path], capture_output=True, text=True, cwd=REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "import OK" in r.stdout
    else:
        res = check_torch_import.main(["--weights", path], device="cpu")
        assert res["tier"] in (1, 2)


@pytest.mark.skipif(_data_root() is None,
                    reason="real LIVECell tree not present "
                           "(no network here); see docs/manifests/")
def test_real_data_matches_manifest():
    dm = json.loads((MANIFESTS / "livecell_data.json").read_text())
    root = Path(_data_root())
    for rep in validate_tree(str(root)):
        assert rep.ok, (rep.split, rep.errors[:5])
    # Tree size within 5% of the DVC pin (partial downloads fail here).
    exp = dm["expected_trees"]["data"]
    total = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    assert total > 0.95 * exp["size_bytes"], \
        f"data tree {total} bytes << pinned {exp['size_bytes']}"
