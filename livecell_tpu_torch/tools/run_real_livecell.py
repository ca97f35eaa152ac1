"""The real-LIVECell runbook: the reference's whole pipeline as one
command (counterpart of scripts/run_real_livecell.sh; reference
README.md:110-217).

    python -m livecell_tpu_torch.tools.run_real_livecell [WORKDIR]

download -> schema validation -> tiling -> DVC pointers for both data
trees -> training in the reference's quirk mode and in the flagship
mode, each with its test COCO AP -> the transfer model from the
checksum-pinned torchvision COCO weights -> stitched visualization of
the test frames. WORKDIR defaults to ./livecell_run. Every stage can be
run again: a finished download (data/.download_done), tiling
(data_split/.tiling_done) or checkpoint is skipped, so a second run
re-runs only the validation, the two pointers, the weights step and the
visualization.

Environment knobs (the shell script's):
  NUM_IMAGES      source frames to tile (default 100)
  EPOCHS          training epochs (default 10)
  BATCH_SIZE      training batch size (default 16)
  SKIP_DOWNLOAD=1 use an existing WORKDIR/data tree

Each stage is a child process, `python -m livecell_tpu_torch.<module>`
with the checkout on its module path, run from WORKDIR on the card. A
child's output (stderr merged into stdout) is printed line by line as it
comes; a child that fails stops the run with its exit code. Weights
that cannot be fetched skip only the transfer stage, with a WARNING;
weights whose sha256 disagrees with the pin (or with the manifest's
full digest, once one is recorded) stop the run with exit 1. Returns
one record a child: its module, command, seconds and the last
TAIL_LINES lines of its output.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import http.client
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

from livecell_tpu_torch.data.download import download_file
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.tools.quality_matrix import REPO, child_env

TV_URL = ("https://download.pytorch.org/models/"
          "maskrcnn_resnet50_fpn_coco-bf2d0c1e.pth")
# torchvision's convention: the file name's suffix is the first 8 hex
# digits of the file's sha256.
PIN = "bf2d0c1e"
MANIFEST = REPO / "docs" / "manifests" / "torchvision_weights.json"
WEIGHTS = "models/maskrcnn_resnet50_fpn_coco.pth"
LIFTED_CAPS = ["--dets", "256", "--infer_nms", "0.7", "--det_nms", "0.6"]
# The lines of a child's output kept in its record.
TAIL_LINES = 1000


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def fetch(url: str, dest: Path) -> bool:
    """Download `url` to `dest`; False, with nothing left at `dest`, when
    the fetch fails."""
    try:
        download_file(url, dest)
        return True
    except (OSError, ValueError, http.client.HTTPException) as e:
        print(f"  fetch of {url} failed: {e}")
        for p in (dest, dest.with_name(dest.name + ".part")):
            p.unlink(missing_ok=True)
        return False


def stream(cmd, cwd, env) -> subprocess.CompletedProcess:
    """Run `cmd` from `cwd` with `env` as subprocess.run does, printing
    the child's output (stderr merged into stdout) line by line as it
    comes; the result's stdout holds its last TAIL_LINES lines."""
    tail = collections.deque(maxlen=TAIL_LINES)
    with subprocess.Popen(cmd, cwd=cwd, env={**env, "PYTHONUNBUFFERED": "1"},
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True) as child:
        for line in child.stdout:
            print(line, end="", flush=True)
            tail.append(line)
    return subprocess.CompletedProcess(cmd, child.returncode, "".join(tail),
                                       "")


def main(argv=None, device=None, runner=stream, env=None) -> List[Dict]:
    """`runner(cmd, cwd=, env=)` runs each child, prints its output and
    returns a CompletedProcess (stream's); `env` (os.environ by default)
    holds the knobs and is the children's environment."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?", default="livecell_run")
    args = parser.parse_args(argv)
    resolve_device(device)
    env = dict(os.environ if env is None else env)
    num_images = env.get("NUM_IMAGES", "100")
    epochs = env.get("EPOCHS", "10")
    batch = env.get("BATCH_SIZE", "16")
    work = Path(os.path.abspath(args.workdir))
    work.mkdir(parents=True, exist_ok=True)
    print(f"== LIVECell real-data run in {work} ==", flush=True)
    records = []

    def run(module: str, *flags: str) -> None:
        cmd = [sys.executable, "-m", f"livecell_tpu_torch.{module}", *flags]
        print(f"== {module} ==", flush=True)
        t0 = time.perf_counter()
        r = runner(cmd, cwd=str(work), env=child_env(env))
        records.append(dict(module=module, cmd=cmd,
                            seconds=time.perf_counter() - t0,
                            stdout=r.stdout, stderr=r.stderr))
        if r.returncode != 0:
            print(f"== {module} failed (exit {r.returncode}) ==",
                  file=sys.stderr)
            raise SystemExit(r.returncode)

    # 1. Download (reference scripts/download_data.py; ~8 GB).
    if env.get("SKIP_DOWNLOAD", "0") != "1" and \
            not (work / "data" / ".download_done").is_file():
        run("data.download", "--dest", "data")
        (work / "data" / ".download_done").touch()

    # 2. Schema validation: fail fast on a malformed tree.
    run("data.validate", "--data_dir", "data")

    # 3. Tiling into the 5x5 grid of 300x222 tiles.
    if not (work / "data_split" / ".tiling_done").is_file():
        run("data.tiling", "--source_dir", "data", "--output_dir",
            "data_split", "--num_images_per_split", num_images)
        (work / "data_split" / ".tiling_done").touch()

    # 4. DVC pointers for both trees.
    run("data.dvc", "--path", "data", "--out", "data.dvc")
    run("data.dvc", "--path", "data_split", "--out", "data_split.dvc")

    # 5a/5b. The reference's quirk mode, then the flagship mode; the
    # trainer saves to models/custom_maskrcnn_<EPOCHS>epochs.ckpt, moved
    # to a name of its own after each run.
    ckpt = work / "models" / f"custom_maskrcnn_{epochs}epochs.ckpt"
    common = ["--data_dir", "data_split", "--batch_size", batch, "--lr",
              "0.001", "--num_epochs", epochs]
    for name, flags in (
            ("custom_quirk", common + ["--coco_ap", "--device_data", "on"]),
            ("custom_fixed", common + [
                "--lr_step_size", "6", "--fixed_heads", "--decode_proposals",
                "--mask_samples", "64", *LIFTED_CAPS, "--coco_ap",
                "--device_data", "on"])):
        if not (work / "models" / f"{name}.ckpt").exists():
            run("train.train_custom", *flags)
            os.replace(ckpt, work / "models" / f"{name}.ckpt")

    # 5c. The transfer model from torchvision's COCO weights (reference
    # src/train_transfer.py:22 pretrained=True), checksum-pinned and
    # checked through the importer before any training.
    weights = work / WEIGHTS
    if not (work / "models" / "transfer_real.ckpt").exists():
        if not weights.is_file():
            weights.parent.mkdir(parents=True, exist_ok=True)
            if not fetch(TV_URL, weights):
                print("WARNING: torchvision weights unreachable — skipping "
                      "the pretrained transfer stage (re-run with network, "
                      "or drop a local .pth at "
                      "models/maskrcnn_resnet50_fpn_coco.pth)", flush=True)
        if weights.is_file():
            got_full = sha256_file(weights)
            got = got_full[:8]
            if got != PIN:
                print(f"ERROR: weight sha256 prefix {got} != pinned {PIN} - "
                      "refusing to load; delete the file and re-download",
                      file=sys.stderr)
                raise SystemExit(1)
            pinned_full = json.loads(MANIFEST.read_text()).get(
                "sha256_full") or ""
            if pinned_full and got_full != pinned_full:
                print(f"ERROR: weight sha256 {got_full} != manifest "
                      f"sha256_full {pinned_full} - refusing to load",
                      file=sys.stderr)
                raise SystemExit(1)
            if not pinned_full:
                print("NOTE: record this host's digest in the manifest: "
                      f"sha256_full={got_full}", flush=True)
            run("tools.check_torch_import", "--weights", WEIGHTS)
            run("train.train_transfer", "--data_dir", "data_split",
                "--batch_size", "4", "--pretrained", WEIGHTS, "--coco_ap",
                "--device_data", "on")
            os.replace(work / "models" / "maskrcnn_resnet50_two_stage.ckpt",
                       work / "models" / "transfer_real.ckpt")

    # 6. Stitched visualization of the test frames (reference
    # src/visualize.py).
    run("serve.visualize", "--model1_path", "models/custom_fixed.ckpt",
        "--model1_type", "custom", "--model1_name", "Custom (fixed)",
        "--test_dir", "data_split/test/images", "--data_dir", "data",
        "--output_dir", "visualizations", *LIFTED_CAPS)
    print(f"== Done. AP numbers: see the train logs above; overlays in "
          f"{work}/visualizations ==", flush=True)
    return records


if __name__ == "__main__":
    main()
