"""DVC-compatible pointer-file generation (counterpart of
livecell_tpu/data/dvc.py, which it copies: the pointers and the config
are byte for byte the JAX package's).

The reference versions its datasets with DVC pointers pushed to a Google
Drive remote (reference data.dvc:1-6, data_split.dvc:1-6, .dvc/config:1-4).
This environment has no gdrive access, so instead of depending on the dvc
package we generate the same artifacts directly: a `.dvc` pointer whose
directory hash is the md5 of the canonical file manifest (DVC's `.dir`
object scheme) plus the `.dvc/config` remote stanza. `dvc pull/push`
against these pointers behaves exactly as with reference-generated ones.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List


def file_md5(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def dir_manifest(root: Path) -> List[Dict[str, str]]:
    """Sorted [{md5, relpath}] manifest of every file under root
    (the content of a DVC `.dir` object)."""
    root = Path(root)
    entries = []
    for p in sorted(root.rglob("*")):
        if p.is_file():
            entries.append({"md5": file_md5(p),
                            "relpath": p.relative_to(root).as_posix()})
    entries.sort(key=lambda e: e["relpath"])
    return entries


def dir_hash(manifest: List[Dict[str, str]]) -> str:
    """md5 of the canonical JSON manifest, with DVC's `.dir` suffix."""
    payload = json.dumps(manifest, sort_keys=True,
                         separators=(",", ": ")).encode()
    return hashlib.md5(payload).hexdigest() + ".dir"


def make_pointer(path: Path) -> str:
    """Render the `.dvc` pointer text for a file or directory
    (format of reference data.dvc / data_split.dvc)."""
    path = Path(path)
    if path.is_dir():
        manifest = dir_manifest(path)
        size = sum((path / e["relpath"]).stat().st_size for e in manifest)
        lines = [
            "outs:",
            f"- md5: {dir_hash(manifest)}",
            f"  size: {size}",
            f"  nfiles: {len(manifest)}",
            "  hash: md5",
            f"  path: {path.name}",
        ]
    else:
        lines = [
            "outs:",
            f"- md5: {file_md5(path)}",
            f"  size: {path.stat().st_size}",
            "  hash: md5",
            f"  path: {path.name}",
        ]
    return "\n".join(lines) + "\n"


def write_pointer(path: Path) -> Path:
    """Write `<path>.dvc` next to the target, like `dvc add`."""
    path = Path(path)
    out = path.parent / f"{path.name}.dvc"
    out.write_text(make_pointer(path))
    return out


def main(argv=None) -> int:
    """CLI: generate a pointer like `dvc add` without the dvc package.

        python -m livecell_tpu_torch.data.dvc --path data_split
    writes data_split.dvc next to the tree (reference data_split.dvc).
    """
    import argparse

    parser = argparse.ArgumentParser(
        description="Generate a DVC-compatible .dvc pointer")
    parser.add_argument("--path", required=True,
                        help="file or directory to version")
    parser.add_argument("--out", default=None,
                        help="pointer file to write "
                             "(default: <path>.dvc beside the target)")
    args = parser.parse_args(argv)

    target = Path(args.path)
    if not target.exists():
        parser.error(f"no such path: {target}")
    if args.out:
        out = Path(args.out)
        out.write_text(make_pointer(target))
    else:
        out = write_pointer(target)
    print(f"wrote {out}")
    return 0


def write_dvc_config(repo_root: Path, remote_url: str,
                     remote_name: str = "storage") -> Path:
    """Write `.dvc/config` with a default remote (reference .dvc/config)."""
    cfg_dir = Path(repo_root) / ".dvc"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg_dir / "config"
    cfg.write_text(
        "[core]\n"
        f"    remote = {remote_name}\n"
        f"['remote \"{remote_name}\"']\n"
        f"    url = {remote_url}\n")
    return cfg


if __name__ == "__main__":
    raise SystemExit(main())
