"""The quality matrix: {sparse, lc, dense} x {reference caps, lifted
caps} -> mask and box AP and F1 (counterpart of
scripts/quality_matrix.py).

The splits come from tools/synth_splits.py: sparse (<= 7 instances a
tile), lc (LIVECell's statistics, ~59 a tile) and dense (~111 a tile).
Each trains one flagship model (`--fixed_heads --decode_proposals
--mask_samples 64`, 10 epochs), then tools/eval_ckpt.py scores the same
checkpoint under

  reference caps - 50 detections, proposal NMS 0.4 (the reference's
                   structural limits);
  lifted caps    - --dets 256 --infer_nms 0.7 --det_nms 0.6.

Writes outputs/quality_matrix.jsonl (one line a cell) and prints a
markdown table.

    python -m livecell_tpu_torch.tools.quality_matrix \\
        --splits sparse:/tmp/synth lc:/tmp/lc dense:/tmp/dense

The children (`python -m livecell_tpu_torch.train.train_custom` and
`python -m livecell_tpu_torch.tools.eval_ckpt`) run on the card. A child
that fails stops the matrix with a non-zero exit after its output's
tail.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from livecell_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
LIFTED_CAPS = ["--dets", "256", "--infer_nms", "0.7", "--det_nms", "0.6"]


def child_env(env=None) -> dict:
    """The environment of a child: `env` (this process's by default),
    with the checkout on the module path."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def last_json_line(text: str):
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def run_child(runner, cmd, cwd, what: str, tail: int = 2000):
    """`runner(cmd)` from `cwd`; a non-zero exit prints the tail of the
    child's output and exits with `what` failed."""
    r = runner(cmd, cwd=cwd, env=child_env(), capture_output=True,
               text=True)
    if r.returncode != 0:
        print(r.stdout[-tail:], r.stderr[-tail:], file=sys.stderr)
        raise SystemExit(f"{what} failed (exit {r.returncode})")
    return r


def eval_row(runner, cmd, cwd, what: str, tail: int = 2000) -> dict:
    """The JSON row an eval_ckpt child printed last; exits when the
    child failed or printed none."""
    r = run_child(runner, cmd, cwd, what, tail)
    rec = last_json_line(r.stdout)
    if rec is None:
        print(r.stdout[-tail:], r.stderr[-tail:], file=sys.stderr)
        raise SystemExit(f"{what} printed no result")
    return rec


def train_cmd(batch_size: int, epochs: int, data_dir: str,
              seed=None) -> list:
    """The flagship quality recipe of the custom trainer."""
    return [sys.executable, "-m", "livecell_tpu_torch.train.train_custom",
            "--batch_size", str(batch_size), "--lr", "0.001",
            "--num_epochs", str(epochs), "--lr_step_size", "6"] + (
        [] if seed is None else ["--seed", str(seed)]) + [
        "--data_dir", data_dir, "--fixed_heads", "--decode_proposals",
        "--mask_samples", "64", "--device_data", "on"]


def eval_cmd(ckpt, data_dir: str, caps: list) -> list:
    return [sys.executable, "-m", "livecell_tpu_torch.tools.eval_ckpt",
            "--ckpt", str(ckpt), "--data_dir", data_dir, "--fixed_heads",
            "--decode_proposals"] + caps


def main(argv=None, device=None, runner=subprocess.run):
    """`runner` runs each child (subprocess.run's signature). Returns
    the rows."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--splits", nargs="+",
                        default=["sparse:/tmp/synth", "lc:/tmp/lc",
                                 "dense:/tmp/dense"],
                        help="name:root pairs; root must contain split/")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--out", default=str(REPO / "outputs" /
                                             "quality_matrix.jsonl"))
    parser.add_argument("--skip_train", action="store_true",
                        help="reuse existing checkpoints")
    args = parser.parse_args(argv)
    resolve_device(device)

    rows = []
    for pair in args.splits:
        name, root = pair.split(":", 1)
        # Absolute: the children run from the root.
        root = Path(os.path.abspath(root))
        ckpt = root / "models" / f"custom_maskrcnn_{args.epochs}epochs.ckpt"
        if not args.skip_train or not ckpt.exists():
            run_child(runner, train_cmd(args.batch_size, args.epochs,
                                        "split"), root, f"train {name}")
            print(f"[{name}] trained", flush=True)
        for caps, extra in (("reference", []), ("lifted", LIFTED_CAPS)):
            rec = eval_row(runner, eval_cmd(ckpt, "split", extra), root,
                           f"eval {name}/{caps}")
            rec.update({"split": name, "caps": caps})
            rows.append(rec)
            print(f"[{name}/{caps}] {json.dumps(rec)}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")

    print("\n| split | caps | mask AP | mask AP50 | mask AP75 "
          "| box AP | F1 |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['split']} | {r['caps']} "
              f"| {r.get('mask_AP', float('nan')):.3f} "
              f"| {r.get('mask_AP50', float('nan')):.3f} "
              f"| {r.get('mask_AP75', float('nan')):.3f} "
              f"| {r.get('box_AP', float('nan')):.3f} "
              f"| {r.get('f1', float('nan')):.3f} |")
    return rows


if __name__ == "__main__":
    main()
