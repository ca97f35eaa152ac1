"""Time the reader of the JAX package's checkpoints
(train/jax_checkpoint.py) by layer, on the host.

    python -m livecell_tpu_torch.tools.bench_ckpt_read CKPT [CKPT ...] \\
        [--repeat 3]

Prints one JSON line per checkpoint directory: its bytes on disk (every
file under it), the bytes the zstd frames decode to, the decoder
(`native.backend()`: "cpp", or "numpy" for the Python twins), and for
each layer the median seconds over `--repeat` reads and the checkpoint
megabytes (on disk, 1e6 bytes) per second: `ocdbt` (the manifest, the
B+tree nodes, reading the values from the data files), `zstd`
(decoding the chunks), `assembly` (the rest: _METADATA, the zarr
arrays, the tree) and `total`; `zstd_decoded_mb_s` is the decoded
megabytes per zstd second. The first read is timed too (the page
cache then holds the files for the others). No device is used.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Dict, List

from livecell_tpu_torch import native
from livecell_tpu_torch.train import jax_checkpoint

LAYERS = ("ocdbt", "zstd", "assembly")


def disk_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def read_stats(path, repeat: int = 3) -> Dict:
    """The row for one checkpoint directory (see the module's doc)."""
    runs = []
    for _ in range(repeat):
        st: Dict = {}
        t0 = time.perf_counter()
        jax_checkpoint.load(path, st)
        st["total_s"] = time.perf_counter() - t0
        runs.append(st)
    mb = disk_bytes(path) / 1e6
    row = {"ckpt": str(path), "backend": native.backend(),
           "disk_mb": mb, "decoded_mb": runs[0]["decoded_bytes"] / 1e6,
           "repeat": repeat, "first_total_s": runs[0]["total_s"]}
    for layer in LAYERS + ("total",):
        s = statistics.median(r[f"{layer}_s"] for r in runs)
        row[f"{layer}_s"] = s
        row[f"{layer}_mb_s"] = mb / s if s > 0 else None
    row["zstd_decoded_mb_s"] = row["decoded_mb"] / row["zstd_s"] \
        if row["zstd_s"] > 0 else None
    return row


def main(argv=None) -> List[Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ckpt", nargs="+")
    parser.add_argument("--repeat", type=int, default=3)
    args = parser.parse_args(argv)
    rows = []
    for path in args.ckpt:
        row = read_stats(path, args.repeat)
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
