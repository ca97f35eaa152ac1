"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so`, compiled by
`nvcc` for sm_90a (Hopper) with a plain C interface; the hash covers the
sources and the flags, so an edited source builds anew and an unchanged
one is reused. `build/` lies inside the package and is not committed.
Nothing is built when a module is imported: `load(name)` builds on its
first call, and `build_all()` builds every source at once, one `nvcc`
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from csrc/ at first use")


def sources() -> List[str]:
    """Names of the CUDA sources, `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, str]:
    """Build every named source (default: all) whose library is missing,
    one nvcc process each, all running at once. Returns each built
    source's compiler log (`-Xptxas=-v`: registers, shared memory,
    spills); raises if any build fails."""
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{logs[n]}" for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
