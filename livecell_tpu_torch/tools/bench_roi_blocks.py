"""Time the RoIAlign kernels at the flagship shapes on the H100 and show
their launch geometry (counterpart of scripts/bench_roi_blocks.py).

JAX's script sweeps the Pallas ROI-block (KB) and channel-block (CB)
sizes. The port's kernels have no such knobs: their blocking is made of
compile-time constants (csrc/roi_common.cuh:147-156, the tiles and
channel slices of K3; csrc/roi_align.cu:114-118, K1's threads), so each
geometry would be a build of its own and there is no sweep. This times
what the kernels do at JAX's two flagship shapes instead:

  box pass : feat [16, 56, 76, 256] bf16, K = 128
  mask pass: feat [16, 56, 76, 256] bf16, K = 64

    python -m livecell_tpu_torch.tools.bench_roi_blocks

Before timing, K1 (roi_weights), K2 (roi_align_fwd) and K3
(roi_align_bwd) are held against their plain versions on these inputs
at chip_smoke.py phase 3's tolerances (K1 equal bit for bit; K2 and K3
within 2 bf16 ulps of the output's magnitude); a disagreement fails the
run. Then K1+K2 forward and K1+K2+K3 forward-backward (through
RoIAlignFunction, output 7, scale 1/4, sampling ratio 2) are timed by
CUDA events over 30 calls back to back. One line a shape: JAX's k,
fwd_ms and fwdbwd_ms (its kb, cb_fwd, kb_bwd and cb_bwd have no
counterpart), the checks, each kernel's launch geometry from a profiled
call (grid, block, registers, static shared memory), K2's and K3's
resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
and the card. Runs on the card; `main([...], device="cpu")` on the CPU,
where the wrappers take their plain versions and no geometry is read.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops import cuda_roi_align as cra
from livecell_tpu_torch.utils.flops import card_of
from livecell_tpu_torch.utils.profiling import per_call_ms, trace

FEAT = (16, 56, 76, 256)
KS = (128, 64)
OUT, SCALE, RATIO = 7, 0.25, 2
CALLS = 30
KERNELS = ("roi_weights_kernel", "roi_align_fwd_kernel", "roi_spans_kernel",
           "roi_align_bwd_kernel")
GEOMETRY = ("grid", "block", "registers per thread", "shared memory")
SESSIONS = 5


def inputs(dev) -> Dict:
    """JAX's draws: the bf16 map, then the boxes of K = 128 and of K = 64
    (x0, y0 over the 304x224 input, sides 20-56 px)."""
    rng = np.random.default_rng(0)
    b, h, w, c = FEAT
    feat = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)
    out = {"feat": feat}
    for k in KS:
        x0 = rng.uniform(0, w * 4 - 60, (b, k))
        y0 = rng.uniform(0, h * 4 - 60, (b, k))
        bw = rng.uniform(20, 56, (b, k))
        bh = rng.uniform(20, 56, (b, k))
        out[k] = torch.from_numpy(np.stack(
            [x0, y0, x0 + bw, y0 + bh], axis=-1).astype(np.float32)).to(dev)
    return out


def bf16_tol(ref: torch.Tensor) -> float:
    """2 bf16 ulps at the output's magnitude (phase 3's K2/K3 rule)."""
    return 2 * 2.0 ** -7 * max(ref.float().abs().max().item(), 1.0)


def check(feat: torch.Tensor, boxes: torch.Tensor, gen: torch.Generator
          ) -> Dict:
    """K1, K2 and K3 against their plain versions on `feat`, `boxes` and
    an output gradient drawn from `gen`; raises on a disagreement."""
    hw = tuple(feat.shape[1:3])
    wy, wx = cra.roi_weights(boxes, hw, OUT, RATIO, SCALE, feat.dtype)
    py, px = cra.roi_weights_plain(boxes, hw, OUT, RATIO, SCALE, feat.dtype)
    k1_equal = torch.equal(wy, py) and torch.equal(wx, px)
    ref = cra.roi_align_fwd_plain(feat, wy, wx)
    k2_err = (cra.roi_align_fwd(feat, wy, wx).float() - ref.float()
              ).abs().max().item()
    k2_tol = bf16_tol(ref)
    g = torch.randn(ref.shape, generator=gen).to(feat.device, feat.dtype)
    ref3 = cra.roi_align_bwd_plain(g, wy, wx, hw)
    k3_err = (cra.roi_align_bwd(g, wy, wx, hw).float() - ref3.float()
              ).abs().max().item()
    k3_tol = bf16_tol(ref3)
    res = dict(k1_equal_to_plain=k1_equal, k2_max_err=k2_err,
               k2_tol=k2_tol, k3_max_err=k3_err, k3_tol=k3_tol)
    if not (k1_equal and k2_err <= k2_tol and k3_err <= k3_tol):
        raise AssertionError(f"RoIAlign kernels disagree with their plain "
                             f"versions at K = {boxes.shape[1]}: {res}")
    return res


def geometry(fn, dev: torch.device) -> Optional[Dict]:
    """Each RoIAlign kernel's launch geometry in a profiled call of `fn`,
    from the trace's kernel events; None on the CPU. A profiler session
    on the card now and then records only some launches, or none: up to
    SESSIONS calls are profiled until every kernel is seen, and a kernel
    still unseen then fails the run."""
    if dev.type != "cuda":
        return None
    out = {}
    for _ in range(SESSIONS):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                fn()
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
        for e in events:
            name = next((k for k in KERNELS if e.get("cat") == "kernel"
                         and k in e.get("name", "")), None)
            if name is not None and name not in out:
                out[name] = {k: e["args"].get(k) for k in GEOMETRY}
        if len(out) == len(KERNELS):
            return {k: out[k] for k in KERNELS}
    raise RuntimeError(f"the profiler recorded no launch of "
                       f"{sorted(set(KERNELS) - set(out))} in {SESSIONS} "
                       f"sessions")


def main(argv=None, device=None) -> List[Dict]:
    """Returns the printed rows."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    dev = resolve_device(device)
    data = inputs(dev)
    feat = data["feat"]
    gen = torch.Generator().manual_seed(0)
    card = card_of(dev)
    resident = None
    if dev.type == "cuda":
        resident = {"roi_align_fwd_kernel":
                    cra.roi_align_fwd_blocks_per_sm(feat.dtype),
                    "roi_align_bwd_kernel":
                    cra.roi_align_bwd_blocks_per_sm(feat.dtype)}
    rows = []
    for k in KS:
        boxes = data[k]
        checks = check(feat, boxes, gen)
        leaf = feat.detach().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                return cra.roi_align(feat, boxes, OUT, SCALE, RATIO)

        def fwdbwd():
            out = cra.roi_align(leaf, boxes, OUT, SCALE, RATIO)
            return torch.autograd.grad(out, leaf, torch.ones_like(out))[0]

        row = {"k": k, "fwd_ms": round(per_call_ms(fwd, dev, calls=CALLS), 4),
               "fwdbwd_ms": round(per_call_ms(fwdbwd, dev, calls=CALLS), 4),
               **checks, "geometry": geometry(fwdbwd, dev),
               "resident_blocks_per_sm": resident, "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
