"""The port's runbook (livecell_tpu_torch/tools/run_real_livecell.py)
against the JAX package's scripts/run_real_livecell.sh.

The shell script runs under bash with shims first on PATH: `python`
logs its argv and leaves what the child would leave (the data trees, the
trainers' checkpoints) and runs `-c` through the real interpreter;
`curl` fails; `sha256sum` prints a chosen digest. The port's `main`
runs with a recording runner that leaves the same files, a failing
fetch and the same digest. In every scenario both run the same children
in the same order (after the module-name mapping), print the same
WARNING/ERROR/NOTE lines, exit with the same code and leave the same
files under WORKDIR/models. Then the data stages run for real on the
CPU, and their tree is held against JAX's tiler and DVC pointer."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from livecell_tpu.data import dvc as jax_dvc
from livecell_tpu.data import tiling as jax_tiling
from livecell_tpu_torch.data import dvc
from livecell_tpu_torch.tools import run_real_livecell as rrl
from tests.util_fakedata import make_fake_livecell

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "run_real_livecell.sh"
PINNED = "bf2d0c1e" + "7" * 56
WRONG = "0123abcd" + "7" * 56

# What a child leaves behind, given its argv after the interpreter (run
# in the shim's process and in the recording runner).
LEAVE = '''
import os


def leave(argv, cwd, env):
    mod = argv[1] if argv[0] == "-m" else argv[0]
    made = {"data.download": "data", "data.tiling": "data_split",
            "train.train_transfer": "models/maskrcnn_resnet50_two_stage.ckpt"}
    if mod.endswith("train.train_custom"):
        epochs = argv[argv.index("--num_epochs") + 1]
        path = f"models/custom_maskrcnn_{epochs}epochs.ckpt"
    else:
        path = next((p for m, p in made.items() if mod.endswith(m)), None)
    if path is not None:
        os.makedirs(os.path.join(cwd, path), exist_ok=True)
        if path.endswith(".ckpt"):
            with open(os.path.join(cwd, path, "model.pt"), "w") as f:
                f.write(mod)
    return int(env.get("FAIL_" + mod.rsplit(".", 1)[-1].upper(), "0"))
'''
namespace = {}
exec(LEAVE, namespace)
leave = namespace["leave"]

PYTHON_SHIM = f'''#!{sys.executable}
import json, os, sys
if sys.argv[1] == "-c":
    os.execv({sys.executable!r}, [{sys.executable!r}] + sys.argv[1:])
{LEAVE}
with open(os.environ["CHILD_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
sys.exit(leave(sys.argv[1:], os.getcwd(), os.environ))
'''


def shims(d: Path) -> Path:
    d.mkdir()
    for name, text in (
            ("python", PYTHON_SHIM),
            ("curl", "#!/bin/sh\necho 'curl: (7) Failed to connect' >&2\n"
                     "exit 7\n"),
            ("sha256sum", '#!/bin/sh\necho "$SHA_DIGEST  $1"\n')):
        (d / name).write_text(text)
        (d / name).chmod(0o755)
    return d


def as_port(argv):
    """A JAX child's argv in the port's module names."""
    if argv[0].endswith("scripts/check_torch_import.py"):
        return ["-m", "livecell_tpu_torch.tools.check_torch_import"] + \
            argv[1:]
    return [a.replace("livecell_tpu.", "livecell_tpu_torch.", 1)
            if a.startswith("livecell_tpu.") else a for a in argv]


def notices(text: str):
    return [line for line in text.splitlines()
            if line.startswith(("WARNING", "ERROR", "NOTE"))]


def files(work: Path):
    models = work / "models"
    return sorted(str(p.relative_to(models)) for p in models.rglob("*")) \
        if models.exists() else []


def run_jax(work: Path, shim_dir: Path, knobs: dict, digest: str):
    log = work.parent / (work.name + ".children")
    env = {"PATH": f"{shim_dir}{os.pathsep}{os.environ['PATH']}",
           "HOME": os.environ.get("HOME", str(work.parent)),
           "CHILD_LOG": str(log), "SHA_DIGEST": digest, **knobs}
    r = subprocess.run(["bash", str(SCRIPT), str(work)], env=env,
                       capture_output=True, text=True, timeout=120)
    children = [json.loads(line) for line in log.read_text().splitlines()] \
        if log.exists() else []
    log.unlink(missing_ok=True)
    return dict(children=[as_port(c) for c in children],
                notices=notices(r.stdout + r.stderr), rc=r.returncode,
                files=files(work))


def recording_runner(children: list):
    def runner(cmd, cwd, env):
        assert cmd[0] == sys.executable
        assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
        children.append(cmd[1:])
        return subprocess.CompletedProcess(
            cmd, leave(cmd[1:], cwd, env), "", "")
    return runner


def run_port(work: Path, knobs: dict, digest: str, capsys, monkeypatch):
    def no_network(url, dest, *a, **k):
        assert url == rrl.TV_URL
        dest.with_name(dest.name + ".part").write_bytes(b"partial")
        raise OSError("connection refused")

    monkeypatch.setattr(rrl, "download_file", no_network)
    monkeypatch.setattr(rrl, "sha256_file", lambda path: digest)
    children = []
    capsys.readouterr()
    try:
        rrl.main([str(work)], device="cpu",
                 runner=recording_runner(children),
                 env={**os.environ, **knobs})
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return dict(children=children, notices=notices(out.out + out.err),
                rc=rc, files=files(work))


def weights_file(work: Path):
    (work / "models").mkdir(parents=True)
    (work / "models" / "maskrcnn_resnet50_fpn_coco.pth").write_bytes(b"w")


# name -> (knobs, digest, set-up of WORKDIR, runs)
SCENARIOS = {
    "fresh, fetch fails": ({}, PINNED, None, 1),
    "re-run of a finished WORKDIR": ({}, PINNED, None, 2),
    "SKIP_DOWNLOAD=1": ({"SKIP_DOWNLOAD": "1"}, PINNED, None, 1),
    "EPOCHS=3 NUM_IMAGES=10": ({"EPOCHS": "3", "NUM_IMAGES": "10"}, PINNED,
                               None, 1),
    "weights with a wrong prefix": ({}, WRONG, weights_file, 1),
    "weights that pass the pin": ({"BATCH_SIZE": "8"}, PINNED,
                                  weights_file, 2),
    "tiling fails": ({"FAIL_TILING": "3"}, PINNED, None, 1),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_children_equal_jax(scenario, tmp_path, capsys, monkeypatch):
    knobs, digest, setup, runs = SCENARIOS[scenario]
    shim_dir = shims(tmp_path / "bin")
    got, want = [], []
    for side in ("jax", "port"):
        work = tmp_path / side
        if setup is not None:
            setup(work)
        for _ in range(runs):
            if side == "jax":
                want.append(run_jax(work, shim_dir, knobs, digest))
            else:
                got.append(run_port(work, knobs, digest, capsys,
                                    monkeypatch))
    assert got == want
    last = got[-1]
    assert last["children"], scenario
    if scenario == "re-run of a finished WORKDIR":
        assert [c[1] for c in last["children"]] == [
            "livecell_tpu_torch.data.validate", "livecell_tpu_torch.data.dvc",
            "livecell_tpu_torch.data.dvc", "livecell_tpu_torch.serve.visualize"]
        assert "custom_fixed.ckpt" in last["files"]
    if scenario == "weights with a wrong prefix":
        assert last["rc"] == 1 and last["notices"][0].startswith(
            "ERROR: weight sha256 prefix 0123abcd")
    if scenario == "weights that pass the pin":
        assert "transfer_real.ckpt" in last["files"]
        assert got[0]["notices"] == [f"NOTE: record this host's digest in "
                                     f"the manifest: sha256_full={PINNED}"]
    if scenario == "fresh, fetch fails":
        assert last["notices"][0].startswith(
            "WARNING: torchvision weights unreachable")
        assert "maskrcnn_resnet50_fpn_coco.pth" not in last["files"]
    if scenario == "tiling fails":
        assert last["rc"] == 3


@pytest.mark.parametrize("fail", ["download", "validate", "tiling", "dvc",
                                  "train_custom", "visualize"])
def test_failed_child_stops_the_run(fail, tmp_path, capsys, monkeypatch):
    """The failing child's exit code comes back; no later child runs."""
    got = run_port(tmp_path / "w", {f"FAIL_{fail.upper()}": "5"}, PINNED,
                   capsys, monkeypatch)
    assert got["rc"] == 5
    assert got["children"][-1][1].endswith("." + fail)
    assert sum(c[1].endswith("." + fail) for c in got["children"]) == 1


def test_full_digest_pin(tmp_path, capsys, monkeypatch):
    """Once the manifest records sha256_full, a file that passes the
    prefix but not the full digest is refused before any child of the
    transfer stage; the recorded digest itself passes without the NOTE."""
    manifest = tmp_path / "manifest.json"
    monkeypatch.setattr(rrl, "MANIFEST", manifest)
    other = PINNED[:-1] + "8"
    for recorded, rc in ((other, 1), (PINNED, 0)):
        manifest.write_text(json.dumps({"sha256_full": recorded}))
        work = tmp_path / recorded[-1]
        weights_file(work)
        got = run_port(work, {}, PINNED, capsys, monkeypatch)
        assert got["rc"] == rc
        mods = [c[1].rsplit(".", 1)[-1] for c in got["children"]]
        if rc:
            assert got["notices"] == [
                f"ERROR: weight sha256 {PINNED} != manifest sha256_full "
                f"{other} - refusing to load"]
            assert "check_torch_import" not in mods
        else:
            assert got["notices"] == []
            assert "train_transfer" in mods


def test_runs_on_the_card_unless_asked(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        rrl.main([str(tmp_path / "w")], runner=None, env={})
    assert not (tmp_path / "w").exists()


def test_data_stages_for_real(tmp_path, capsys, monkeypatch):
    """validate -> tile -> DVC as real child processes over a 4/1/1-frame
    tree (the trainers, the weights step and visualize recorded): the
    tiled tree equals JAX's tiler's on the same tree file for file, and
    both pointers equal JAX's."""
    work = tmp_path / "w"
    make_fake_livecell(work / "data", images_per_split=(4, 1, 1))
    children = []
    fake = recording_runner(children)

    def runner(cmd, cwd, env):
        if cmd[2].startswith("livecell_tpu_torch.data."):
            children.append(cmd[1:])
            return rrl.stream(cmd, cwd, env)
        return fake(cmd, cwd, env)

    monkeypatch.setattr(rrl, "fetch", lambda url, dest: False)
    rrl.main([str(work)], device="cpu", runner=runner,
             env={**os.environ, "SKIP_DOWNLOAD": "1"})
    out = capsys.readouterr().out
    assert "[OK] train: 4 images" in out and "[FAIL]" not in out
    assert [c[1].rsplit(".", 1)[-1] for c in children] == [
        "validate", "tiling", "dvc", "dvc", "train_custom", "train_custom",
        "visualize"]

    jax_split = tmp_path / "jax" / "data_split"
    jax_tiling.main(["--source_dir", str(work / "data"), "--output_dir",
                     str(jax_split), "--num_images_per_split", "100"])
    (jax_split / ".tiling_done").touch()

    def tree(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    got, want = tree(work / "data_split"), tree(jax_split)
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".png") for k in got) == 6 * 25
    for k in want:
        assert got[k] == want[k], k
    assert (work / "data_split.dvc").read_text() == \
        jax_dvc.make_pointer(jax_split)
    assert (work / "data.dvc").read_text() == \
        jax_dvc.make_pointer(work / "data")
    assert f"md5: {dvc.dir_hash(dvc.dir_manifest(work / 'data_split'))}" in \
        (work / "data_split.dvc").read_text()


def test_stream_prints_as_it_comes(tmp_path, capsys, monkeypatch):
    """The default runner prints a child's lines (stderr merged) while
    the child runs, keeps the last TAIL_LINES in its result and returns
    the child's exit code."""
    monkeypatch.setattr(rrl, "TAIL_LINES", 3)
    marker = tmp_path / "go"
    child = (
        "import os, sys, time\n"
        "print('first', flush=True)\n"
        f"while not os.path.exists({str(marker)!r}): time.sleep(0.01)\n"
        "print('to stderr', file=sys.stderr, flush=True)\n"
        "for i in range(4): print(f'line {i}')\n"
        "sys.exit(4)\n")
    seen = []
    real_print = print

    def spy(*a, **k):
        # The first line is printed before the child may go on.
        seen.append(a[0])
        marker.touch()
        real_print(*a, **k)

    monkeypatch.setattr("builtins.print", spy)
    r = rrl.stream([sys.executable, "-c", child], str(tmp_path),
                   dict(os.environ))
    monkeypatch.undo()
    assert seen == ["first\n", "to stderr\n"] + [
        f"line {i}\n" for i in range(4)]
    assert r.returncode == 4
    assert r.stdout == "line 1\nline 2\nline 3\n" and r.stderr == ""
    assert capsys.readouterr().out.startswith("first\nto stderr\n")


def test_children_write_their_launch_counts(tmp_path):
    """With LIVECELL_LAUNCH_LOG set, a process that imports the port
    appends its kernels' launch counts at its exit (ops/launch_log.py),
    each counter from zero, on a normal exit and on SystemExit alike."""
    log = tmp_path / "launches.jsonl"
    env = {**os.environ, "LIVECELL_LAUNCH_LOG": str(log),
           "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c",
                    "from livecell_tpu_torch.ops import cuda_roi_align as c\n"
                    "c.roi_weights.launches += 3\n"
                    "raise SystemExit(2)"], env=env, timeout=120)
    subprocess.run([sys.executable, "-m", "livecell_tpu_torch.data.dvc",
                    "--help"], env=env, capture_output=True, timeout=120)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["launches"] for r in rows] == [
        {"roi_weights": 3, "roi_align_fwd": 0, "roi_align_bwd": 0,
         "match_anchors": 0, "ms_roi_align_fwd": 0, "ms_roi_align_bwd": 0},
        dict.fromkeys(rows[0]["launches"], 0)]
    assert rows[1]["argv"][0].endswith(os.path.join("data", "dvc.py"))
