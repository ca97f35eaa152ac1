#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (livecell_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device is required; prints nvidia-smi's name and
     power limit;
  2. build: builds every kernel from livecell_tpu_torch/csrc with nvcc;
  3. kernels: every kernel against its plain PyTorch version on the card,
     each within its stated tolerance, timed with CUDA events and the
     profiler: K1 (roi_weights) and K2 (roi_align_fwd) at the serving
     shapes (25 tiles, 56x76x256 map, K in {50, 256}, and request (b)'s
     one tile, K = 50; bf16 and f32) and at the training shape (32
     images, K = 128, bf16); K1 equal to its plain version bit for bit
     in both dtypes, there and on edge boxes at sampling ratios 2 and 6,
     two calls equal; K2 also equal to its plain version bit for
     bit in bf16 (`equal_to_plain`, recorded in f32), two calls equal
     bit for bit, its resident blocks per SM (at least 2), and within
     tolerance on weights of sampling ratio 6 (rows longer than its tap
     lists); K4 (match_anchors, full and max-only; max IoU and best
     anchor equal to the plain version bit for bit, targets within 1e-5
     relative, two calls equal) at the fixed mode's 32 images x 128 GT,
     the quirk mode's 1 x 4,096 and 32 x 128 with every slot valid (the
     most work); K3 (roi_align_bwd, bf16 and
     f32) at 32 x 128 and 1 x 128 ROIs and on one box covering the map,
     its spans pre-pass covering the plain spans, two calls equal bit for
     bit, and its resident blocks per SM (at least 2); K2's and K3's
     library yardsticks (one three-operand torch.einsum each) checked and
     timed too;
  4. serve: the full-width model (ResNet-18/CBAM/FPN-256 at 224x304,
     bf16, random weights from a seed) serves three requests through
     InferenceEngine.predict: (a) a 704x520 frame with the reference
     defaults, (b) a 300x222 tile, (c) a frame with decode_proposals
     and --dets 256 --infer_nms 0.7 --det_nms 0.6. The launch counters
     must show K1 and K2 ran once per forward (twice in (c));
  5. end to end: request (a)'s forward in f32 with roi_backend="kernel"
     and "plain", same weights, must agree (valid equal; boxes, scores
     and mask probabilities within 1e-3);
  6. train: the full-width model with f32 master weights and bf16
     compute takes 3 warm-up and 10 timed steps through train_epoch at
     batch 32 from a pool of 128 synthetic tiles on the card, in (T1)
     the reference's quirk mode and (T2) the flagship fixed mode
     (heads_all_images, decode_proposals, mask_train_samples=64): finite
     losses, and K1-K4 launched once per step each; one profiled step
     per mode;
  7. train end to end: one f32 step of T2 at batch 4 with the kernels
     and with their plain versions: equal selections, losses and every
     parameter's gradient within the stated tolerances;
  8. checkpoint: the T2 model saved by train/checkpoint.py, loaded by
     serve/app.py:load_model, serves a tile;
  9. transfer kernels: K5 (ms_roi_align_fwd) and K6 (ms_roi_align_bwd)
     against their plain versions on a P2-P5 pyramid of the 800x1088
     canvas (256 channels) at the training shapes (4 images, K = 512 at
     7x7 and K = 128 at 14x14) and the serving shapes (25 tiles, K =
     1,000 at 7x7 and K = 100 at 14x14), in bf16 and f32, on elongated
     boxes and on one box covering the canvas; K5 as K2 above; K6 as
     K3 above, and a level without ROIs must get an all-zero gradient;
     K4 (full) at
     217,413 anchors x 4 images x 128 GT; timed with CUDA events and the
     profiler (a kernel's device time sums every kernel its wrapper
     launches, pre-pass included);
 10. transfer serving: the full-width transfer R50-FPN Mask R-CNN
     (TransferConfig defaults, bf16, random weights from a seed) serves a
     704x520 frame through make_frame_predictor: first call, steady
     median of 5, K5 launched twice per forward;
 11. transfer training (T3): bench.py's transfer step (batch 4, SGD 5e-3,
     momentum 0.9, clip 10) with f32 master weights and bf16 compute for
     3 warm-up and 10 timed steps: finite losses, K4/K5/K6 launched
     1/2/2 times per step; one profiled step, one stage-1 step (backbone,
     FPN and RPN frozen);
 12. transfer end to end: one f32 step at batch 1 with the kernels and
     with their plain versions: equal selections, losses and gradients
     within the stated tolerances;
 13. data on the card: a 15-frame 704x520 split at LIVECell statistics
     (~305 instances a frame) drawn with numpy and rasterized by the
     port's C++ routine (which must have built), cut into 375 tiles by
     data/tiling.py:tile_frame and written with the port's PNG encoder
     with a COCO JSON; packed by PackedDataset on the card and on the
     CPU: the decoded tiles equal the drawn pixels bit for bit, the
     card's mask targets within one count of the CPU's on at most 0.1%
     of the entries; held on the card by DeviceDataset.from_packed;
     prints the pack time (host clock), the mask-target precompute
     (CUDA events) and the bytes held;
 14. evaluation on the card: COCO AP (segm and bbox, with the box
     metrics) by train/coco_eval.py and metrics.evaluate over the 375
     tiles, for the full-width custom model (batch 32) and the transfer
     model (batch 4), bf16, seed-0 weights, each with roi_backend
     "kernel" and "plain": the two routes agree within 1e-6 in every AP
     and box metric, K1/K2 run once per custom batch and K5 twice per
     transfer batch on the kernel route; the card's IoU path gives the
     CPU's AP on detections placed near the GT; K1/K2 and K5 against
     their plain versions at the eval batches' shapes. Prints tiles/s
     and the host AP code's share of the wall time;
 15. custom trainer CLI: a "sparse" split (scripts/make_synth_splits.py's
     mode: 12 ellipses a frame, 14/3/3 frames -> 350/75/75 tiles) drawn
     with numpy and the port's C++ raster, then
     train/train_custom.py:main with the flagship quality command
     (batch 16, 10 epochs, --lr_step_size 6 --fixed_heads
     --decode_proposals --mask_samples 64 --coco_ap --device_data on),
     full-width ModelConfig(), bf16, from a temporary working directory:
     K1-K4 once per training step, K1/K2 once per RoIAlign pass of each
     eval batch (two with decode_proposals), finite losses, meta.json at
     epoch 10, the checkpoint served through InferenceEngine(model_path)
     on request (a)'s frame, test mask AP50 >= 0.5; K1-K4 against their
     plain versions (as in phase 3) on the inputs the CLI gave them, the
     first training step's (K1/K2/K3 at 16 x 128 ROIs, K4 full and
     max-only at 16 images x 32 slots) and both RoIAlign passes of the
     first test batch (16 x 50); prints each epoch's seconds and img/s,
     the box metrics and the test mask AP/AP50/AP75;
 16. transfer trainer CLI: its own "sparse" split, then
     train/train_transfer.py:main (batch 4, 2 + 8 epochs, clip 10,
     --coco_ap --device_data on), full-width TransferConfig() from
     seed-0 weights: K4/K5/K6 1/2/2 per training step, K5 twice per eval
     batch, the backbone, FPN and RPN bit for bit unchanged over stage
     1 and moved by stage 2, a checkpoint that names the transfer model
     and serves a frame and a 300x222 tile (K5 twice each), test mask
     AP50 >= 0.5; prints each stage's epoch seconds and img/s and the
     test mask and box AP/AP50/AP75; then the CLI again with --mfu and
     no epochs: each stage's analytic step TFLOP and a numeric MFU;
 17. serve front ends: a 15-frame "sparse" test split (375 tiles), its
     frames' polygon annotations kept, through the visualize CLI's own
     stages (serve/visualize.py:frame_stages: tiles decoded by
     load_tiles, both trained checkpoints of phases 15 and 16 through
     their frame predictors' pinned, non-blocking dispatch and fetch)
     driven by serve/pipeline.py:run_pipelined, with a consume that
     builds the panels with numpy only (GT overlay, both models'
     prediction overlays, composited over reconstruct_full_image, held
     as arrays; matplotlib is not on the card's machine): load_tiles
     equal to the drawn tiles and the reconstructed frame to the drawn
     frame bit for bit, pipelined detections equal to each predictor's serial
     run() bit for bit, no frame lost or failed, K1/K2 once per custom
     RoIAlign pass (two with decode_proposals) and K5 twice per
     transfer frame, K1/K2 and K5 against their plain versions on the
     first frame's inputs, stitched-frame box F1 (train/metrics.py,
     IoU 0.5) >= 0.5 for both models; the explainer's capture
     (serve/explain.py) on three tiles with the custom checkpoint in
     f32, roi_backend "kernel" and "plain": twelve finite stages,
     importance summing to 100, the ten stages before the heads equal,
     the heads within 1e-3 of their magnitude, K1/K2 per tile as
     above; no frame's dispatch makes a synchronizing call
     (torch.cuda.set_sync_debug_mode "error"). Prints per-frame decode,
     device and overlay ms, pipelined frames/s against the serial sum,
     how long dispatch holds the host against a frame's device time
     (and a pageable copy's dispatch against the pinned one behind 50
     ms of queued device work), launches per frame and tile, and the F1
     values, with the card's name and power limit.

 18. mesh (phase_mesh_flops, phase_mesh_nccl, phase_mesh_gloo): FLOP
     counts and MFU of T1-T3 and requests (a), (d), a traced T1 step,
     world size 1 over NCCL, two gloo ranks on the card;
 19. quality tools (phase_quality_tools) on phase 15's checkpoint;
 20. measurement tools (phase_measure_tools): livecell_tpu_torch/tools/
     profile_step, trace_summary, profile_transfer, roofline,
     bench_roi_blocks (K1-K3 at 16 x 56x76x256, K = 128 and 64, against
     their plain versions), check_torch_import (a seeded
     torchvision-layout file refused at the zero-shot gate, then passed
     with its RPN bias leaned), bench_serve, bench_transfer_nms (K5
     against its plain version on its inputs at B = 1, K = 512 and 1000
     at 7x7, K = 100 at 14x14), bench_nms and bench_conv1, each in
     process on the card, its JSON parsed and its times finite and > 0,
     the launches of each path the tools drive counted per call; the
     roofline FLOPs of T2 and T3 equal to phase 18's.
 21. real-data runbook (phase_runbook): tools/run_real_livecell.py:main
     with the real subprocess.run over a "sparse" LIVECell source tree
     of 14/3/3 grey TIFF frames (tools/synth_splits.make_fake_livecell),
     NUM_IMAGES=20 SKIP_DOWNLOAD=1 EPOCHS=10 BATCH_SIZE=16, the weights'
     URL refused: validation passes, 350/75/75 tiles, the data pointer
     equal to data/dvc.py's hash of its tree, both custom checkpoints
     (quirk and flagship) load and name their model, each trainer
     prints its test mask AP (flagship AP50 >= 0.5), the transfer stage
     is skipped with its WARNING, a panel a test frame; a re-run starts
     only validate, both pointers (then equal to their trees) and
     visualize, and retrains nothing; a seeded torchvision-layout file
     at the weights' path stops a third run with exit 1 before any
     child of the transfer stage. Prints each stage's seconds and the
     tiling frames/s. The children's kernels run in their own
     processes and are not counted.
 22. JAX checkpoints (phase_jax_ckpt): the native library built from
     the checkout's sources with g++ (`native.backend()` "cpp"); the
     two committed Orbax directories of tests/fixtures/jax_ckpt (the
     JAX package's custom trainer's full save and transfer trainer's
     bare save, written by tests/jax_ckpt_fixtures.py) read by
     train/jax_checkpoint.py, every leaf's SHA-256 equal to leaves.json,
     the reader's seconds and MB/s by layer printed; the custom one
     served on its tile through InferenceEngine (K1/K2 twice), the
     transfer one (TransferConfig() in f32) on its tile through the
     engine and on request (a)'s frame through make_frame_predictor (K5
     twice each), the detections held against JAX's recorded outputs
     (JAX_CKPT_TOL), and K1/K2 and K5 against their plain versions on
     the inputs each request gave them; the custom one resumed by
     train_custom --resume for one epoch on a 2/1/1-frame "sparse"
     split: start epoch 3 (its meta epoch 2 + 1), the step count and
     learning rate of optax's schedule continued, K1-K4 once a step, and
     K1-K4 against their plain versions on the first resumed step's
     inputs (cli_kernel_cases).

Each phase prints its seconds. Prints the kernels' JSON line, then as
the last line {"ok": true, "device": {...}}. Writes nothing outside the
checkout but, under $TMPDIR, a temporary checkpoint, the split of
phases 13-14, the splits and working directories of phases 15 and 16,
each removed when its phase ends, the split of phase 17 and copies of
the two trained checkpoints, removed when phase 17 ends, and the
working directories of phases 21 and 22, removed when each ends; the
kernels and the native library build into a directory inside the
package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
B, H, W, C = 25, 56, 76, 256     # a frame's tiles, stride-4 map of 224x304
OUT, RATIO, SCALE = 7, 2, 0.25


def log(*a):
    print(*a, flush=True)


class Phase:
    """Logs a phase's number, name and seconds when it ends."""

    def __init__(self, n: int, name: str):
        self.n, self.name = n, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase {self.n}] {self.name}: "
                f"{time.perf_counter() - self.t0:.1f} s")


def time_ms(fn, warmup=3, runs=21, calls=10) -> float:
    """Time per call by CUDA events (utils/profiling.per_call_ms): the
    median over `runs` runs, each of `calls` back-to-back calls (so the
    host's enqueue overlaps the device's work), divided by `calls`."""
    from livecell_tpu_torch.utils.profiling import per_call_ms
    return per_call_ms(fn, "cuda", calls=calls, warmup=warmup, runs=runs)


def kernel_ms(fn, kernels: tuple, calls=10):
    """Device time per call of `fn` spent in the CUDA kernels whose names
    contain one of `kernels` (all the kernels one wrapper call launches,
    e.g. a pre-pass and the main kernel, each once a call), from a
    utils/profiling.trace session (its warm-up step keeps the session
    from losing its first launches): their summed time over `calls`
    calls, divided by `calls` (excludes the host's launch gaps). Up to
    five sessions are tried for one that recorded every launch; if none
    did, the last session's mean time per recorded launch of each kernel
    is summed instead, and the shortfall logged; if it recorded none of
    them, None (not measured) is returned and logged: a kernel's launch
    is shown by its counter and its output, not by the profiler."""
    from torch.autograd import DeviceType

    from livecell_tpu_torch.utils.profiling import trace

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(5):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                for _ in range(calls):
                    fn()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and any(k in ev.key for k in kernels)]
        counts = {k: sum(ev.count for ev in rows if k in ev.key)
                  for k in kernels}
        if all(n == calls for n in counts.values()):
            break
    else:
        if not any(counts.values()):
            log(f"[kernels] profiler recorded none of {kernels} in five "
                f"sessions: device ms not measured")
            return None
        log(f"[kernels] profiler recorded {counts} of {calls} calls of "
            f"{kernels}: summing each kernel's mean per recorded launch")
        return sum(sum(ev.self_device_time_total for ev in rows
                       if k in ev.key) / n
                   for k, n in counts.items() if n) / 1e3
    return sum(ev.self_device_time_total for ev in rows) / 1e3 / calls


def make_boxes(k: int, gen: torch.Generator) -> torch.Tensor:
    """[B, K, 4] boxes on the 224x304 input: 60% ordinary, 20% crossing
    the border, 20% thinner than one feature pixel (4 input px)."""
    u = torch.rand((B, k, 6), generator=gen)
    x1 = u[..., 0] * 280.0
    y1 = u[..., 1] * 200.0
    bw = 8.0 + u[..., 2] * 112.0
    bh = 8.0 + u[..., 3] * 112.0
    kind = u[..., 4]
    cross = (kind >= 0.6) & (kind < 0.8)
    thin = kind >= 0.8
    x1 = torch.where(cross, x1 - 150.0, x1)
    y1 = torch.where(cross & (u[..., 5] > 0.5), y1 + 120.0, y1)
    bw = torch.where(thin, u[..., 5] * 3.5, bw)
    boxes = torch.stack([x1, y1, x1 + bw, y1 + bh], dim=-1)
    return boxes.contiguous()


def k2_operations(wy: torch.Tensor, wx: torch.Tensor, c: int) -> float:
    """Multiply-adds the data needs, x2: per ROI, each row contraction
    over its non-zero y taps for every column any bin reads, then each
    column contraction over its non-zero x taps."""
    ny = (wy != 0).sum(-1).float()                   # [B, K, n]
    nx = (wx != 0).sum(-1).float()
    xs = (wx != 0).any(dim=2).sum(-1).float()        # [B, K] columns read
    row = ny.sum(-1) * xs
    col = nx.sum(-1) * wy.shape[2]
    return float(2.0 * c * (row + col).sum())


def k2_library(feat: torch.Tensor, wy: torch.Tensor,
               wx: torch.Tensor) -> torch.Tensor:
    """K2's function as one PyTorch call: out[b,k,p,q,c] =
    sum_y sum_x Wy[b,k,p,y] Wx[b,k,q,x] F[b,y,x,c]. Timed as K2's library
    yardstick; the port never calls it."""
    return torch.einsum("bkph,bkqw,bhwc->bkpqc", wy, wx, feat)


def bound(nbytes: float, ops: float) -> tuple:
    """The least time the card could take, in ms, and what bounds it:
    bytes over the HBM rate or f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                  else "operations")


def k12_cases(cra, feat: torch.Tensor, boxes: torch.Tensor, out: int = OUT,
              ratio: int = RATIO, scale: float = SCALE,
              label: str = "") -> list:
    """K1 and K2 against their plain versions on one map [B, H, W, C] and
    one box set [B, K, 4] (K1 at `out`, `ratio`, `scale`), checked and
    timed; K2's library yardstick (one three-operand torch.einsum)
    checked and timed too."""
    dtype = feat.dtype
    b, h, w, c = feat.shape
    k = boxes.shape[1]
    name = f"{label + ' ' if label else ''}B={b} K={k} " \
        f"{str(dtype).split('.')[-1]}"
    esz = feat.element_size()
    # K1: equal to its plain version bit for bit, in both dtypes.
    wy, wx = cra.roi_weights(boxes, (h, w), out, ratio, scale, dtype)
    py, px = cra.roi_weights_plain(boxes, (h, w), out, ratio, scale, dtype)
    err1 = max((wy.float() - py.float()).abs().max().item(),
               (wx.float() - px.float()).abs().max().item())
    exact1 = torch.equal(wy, py) and torch.equal(wx, px)
    same1 = all(torch.equal(a, b) for a, b in zip(
        (wy, wx), cra.roi_weights(boxes, (h, w), out, ratio, scale, dtype)))
    # K2, on the kernel's own weights.
    res = cra.roi_align_fwd(feat, wy, wx)
    same = torch.equal(res, cra.roi_align_fwd(feat, wy, wx))
    ref = cra.roi_align_fwd_plain(feat, wy, wx)
    diff = (res.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    # bf16: the row result and the output are rounded to bf16 in both,
    # after f32 sums taken in another order, which can flip a rounding:
    # 2 bf16 ulps at the output's magnitude. f32: reassociation of <= 16
    # taps, 1e-5 relative.
    tol2 = (2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
        * max(mag, 1.0)
    # The kernel sums the non-zero taps in order, as the plain einsum does
    # over its zeros: in bf16 the two agree bit for bit; in f32 cuBLAS may
    # take its own order (recorded, not required).
    exact = torch.equal(res, ref)
    blocks = cra.roi_align_fwd_blocks_per_sm(dtype)
    torch.cuda.synchronize()
    log(f"[kernels] {name}: K1 max_err {err1:.3g}, equal to plain "
        f"{exact1}, two calls equal {same1}; K2 max_err {diff:.3g} (tol "
        f"{tol2:.3g}), equal to plain {exact}, two calls equal {same}, "
        f"blocks/SM {blocks}")
    if not (exact1 and same1 and diff <= tol2 and same and blocks >= 2
            and (exact or dtype != torch.bfloat16)):
        raise AssertionError(f"kernel disagrees with plain at {name}")
    # The library call rounds at other points (bf16 products or bf16 row
    # sums, then the output): each side is off by at most ~2 bf16
    # half-ulps of the map's magnitude, so 2^-6 of max|F| in bf16; f32
    # sums in another order, 1e-5 of max|F|.
    lib = k2_library(feat, wy, wx)
    fmax = feat.float().abs().max().item()
    err_lib = (lib.float() - ref.float()).abs().max().item()
    tol_lib = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * fmax
    torch.cuda.synchronize()
    log(f"[kernels] {name}: library einsum vs plain K2 max_err "
        f"{err_lib:.3g} (tol {tol_lib:.3g})")
    if not err_lib <= tol_lib:
        raise AssertionError(f"library K2 disagrees with plain at {name}")
    del lib

    k1_bytes = boxes.numel() * 4 + (wy.numel() + wx.numel()) * esz
    k1_ops = 12.0 * ratio * (wy.numel() + wx.numel())
    k2_bytes = (feat.numel() + wy.numel() + wx.numel() + res.numel()) * esz
    k2_ops = k2_operations(wy, wx, c)
    shape = dict(B=b, H=h, W=w, C=c, K=k, dtype=str(dtype),
                 **({"out": out, "case": label} if label else {}))
    cases = []
    for kname, fn, plain, library, nbytes, ops, err, tol, extra in (
        ("roi_weights",
         lambda: cra.roi_weights(boxes, (h, w), out, ratio, scale, dtype),
         lambda: cra.roi_weights_plain(boxes, (h, w), out, ratio, scale,
                                       dtype),
         None, k1_bytes, k1_ops, err1, 0.0,
         dict(two_calls_equal=same1, equal_to_plain=exact1)),
        ("roi_align_fwd", lambda: cra.roi_align_fwd(feat, wy, wx),
         lambda: cra.roi_align_fwd_plain(feat, wy, wx),
         lambda: k2_library(feat, wy, wx),
         k2_bytes, k2_ops, diff, tol2,
         dict(two_calls_equal=same, equal_to_plain=exact,
              blocks_per_sm=blocks)),
    ):
        bms, bby = bound(nbytes, ops)
        cases.append(dict(
            name=kname, shape=shape, max_err=err, tol=tol,
            ms=time_ms(fn), plain_ms=time_ms(plain),
            library_ms=time_ms(library) if library else None,
            library_err=err_lib if library else None,
            library_tol=tol_lib if library else None,
            kernel_ms=kernel_ms(fn, (kname + "_kernel",)),
            bound_ms=bms, bound_by=bby, bytes=nbytes, operations=ops,
            **extra))
    del res, ref, wy, wx, py, px
    torch.cuda.empty_cache()
    return cases


def phase_kernels(cra) -> list:
    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    feat32 = torch.randn((B, H, W, C), generator=gen).to(dev)
    cases = []
    for k in (50, 256):
        boxes = make_boxes(k, gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            cases += k12_cases(cra, feat32.to(dtype), boxes)
            if k == 50:
                # Request (b): one tile.
                cases += k12_cases(cra, feat32[:1].to(dtype),
                                   boxes[:1].contiguous())
    # Weights of sampling ratio 6 on boxes of about the map's size and
    # larger have rows of more non-zero taps than K2's lists hold: such a
    # ROI is gathered from its weight rows. Up to 12 taps a row are summed
    # in another order than the plain einsum's: K2's tolerance, 2 bf16
    # ulps.
    feat = feat32[:1].to(torch.bfloat16)
    big = torch.tensor([[[0.0, 0.0, 4.0 * W, 4.0 * H],
                         [-100.0, -60.0, 4.0 * W + 90.0, 4.0 * H + 70.0],
                         [30.0, 20.0, 250.0, 190.0]]], device=dev)
    wy, wx = cra.roi_weights(big, (H, W), OUT, 6, SCALE, torch.bfloat16)
    long_rows = int((cra.roi_taps_plain(wy, wx)[2] > 2 * cra.MAX_RATIO)
                    .sum())
    ref = cra.roi_align_fwd_plain(feat, wy, wx)
    err = (cra.roi_align_fwd(feat, wy, wx).float() - ref.float()).abs() \
        .max().item()
    tol = 2 * 2.0 ** -7 * max(ref.float().abs().max().item(), 1.0)
    log(f"[kernels] K2 at sampling ratio 6, B=1 K=3 bf16: "
        f"{long_rows} rows longer than a list, max_err {err:.3g} (tol "
        f"{tol:.3g})")
    if not (long_rows and err <= tol):
        raise AssertionError("K2 disagrees with plain on long rows")
    k1_edges(cra, dev)
    return cases


def k1_edges(cra, dev) -> None:
    """K1 equal to its plain version bit for bit on edge boxes of the
    224x304 input (thinner than a feature pixel, across each border,
    wholly outside, a point, the whole map, larger than the map) at
    sampling ratios 2 and 6, in both dtypes."""
    edges = torch.tensor([[[40.0, 48.0, 46.0, 160.0],
                           [80.0, 32.0, 200.0, 35.0],
                           [-120.0, -80.0, 48.0, 36.0],
                           [240.0, 176.0, 360.0, 280.0],
                           [-360.0, 40.0, -160.0, 120.0],
                           [40.0, 480.0, 160.0, 640.0],
                           [132.0, 84.0, 132.0, 84.0],
                           [0.0, 0.0, 4.0 * W, 4.0 * H],
                           [-100.0, -60.0, 4.0 * W + 90.0, 4.0 * H + 70.0]]],
                         device=dev)
    for ratio in (2, 6):
        for dtype in (torch.bfloat16, torch.float32):
            got = cra.roi_weights(edges, (H, W), OUT, ratio, SCALE, dtype)
            want = cra.roi_weights_plain(edges, (H, W), OUT, ratio, SCALE,
                                         dtype)
            eq = all(torch.equal(a, b) for a, b in zip(got, want))
            log(f"[kernels] K1 edge boxes, ratio {ratio}, "
                f"{str(dtype).split('.')[-1]}: equal to plain {eq}")
            if not eq:
                raise AssertionError(f"K1 disagrees with plain on edge boxes "
                                     f"at ratio {ratio}, {dtype}")


def train_gt(b: int, slots: int, rng: np.random.Generator, h: int = 224,
             w: int = 304, n_inst: int = 40):
    """bench.py's synthetic training targets: 40 (`n_inst`) boxes of
    20-55 px per h x w tile in `slots` slots, uint8 mask28. Where four
    slots are free, image 1 repeats three of its boxes in them (duplicate
    GT, so GT tie) and puts one box on an anchor's exact coordinates, and
    image 2 has every slot invalid."""
    from livecell_tpu_torch.ops.anchors import generate_anchors
    boxes = np.zeros((b, slots, 4), np.float32)
    for bi in range(b):
        x1 = rng.uniform(0, w - 60, n_inst)
        y1 = rng.uniform(0, h - 60, n_inst)
        bw, bh = rng.uniform(20, 55, n_inst), rng.uniform(20, 55, n_inst)
        boxes[bi, :n_inst] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
    valid = np.zeros((b, slots), bool)
    valid[:, :n_inst] = True
    if b > 2 and n_inst + 4 <= slots:
        anchors = generate_anchors((h // 4, w // 4))
        boxes[1, n_inst:n_inst + 3] = boxes[1, :3]
        boxes[1, n_inst + 3] = anchors[len(anchors) // 2]
        valid[1, n_inst:n_inst + 4] = True
        valid[2] = False
    mask28 = (rng.uniform(size=(b, slots, 28, 28)) > 0.5).astype(np.uint8) \
        * 255
    return boxes, valid, mask28


def k3_operations(wy: torch.Tensor, wx: torch.Tensor, c: int) -> float:
    """Multiply-adds K3's data needs, x2: per ROI and bin row p, u over
    the non-zero x taps of every bin column q, then each non-zero y tap
    of row p times every column the ROI reads."""
    ny = (wy != 0).sum(-1).float()                   # [B, K, n]
    nx = (wx != 0).sum(-1).float()
    xs = (wx != 0).any(dim=2).sum(-1).float()        # [B, K]
    u = nx.sum(-1) * wy.shape[2]
    d = ny.sum(-1) * xs
    return float(2.0 * c * (u + d).sum())


def k3_library(g: torch.Tensor, wy: torch.Tensor,
               wx: torch.Tensor) -> torch.Tensor:
    """K3's function as one PyTorch call, its library yardstick; the
    port never calls it."""
    return torch.einsum("bkph,bkqw,bkpqc->bhwc", wy, wx, g)


def k4_case(cm, anchors: torch.Tensor, gt: torch.Tensor, v: torch.Tensor,
            full: bool, label: str) -> dict:
    """K4 (full or max-only) against its plain version on anchors [N, 4]
    and GT [B, I, 4], checked and timed."""
    b, i = v.shape
    n = anchors.shape[0]
    got = cm.match_anchors(anchors, gt, v, full)
    again = cm.match_anchors(anchors, gt, v, full)
    want = cm.match_anchors_plain(anchors, gt, v, full)
    if not full:
        got, again, want = (got,), (again,), (want,)
    torch.cuda.synchronize()
    # max_iou bit for bit (the same rounded operations as the plain
    # version); the targets within 1e-5 relative (logf against torch.log).
    err_iou = (got[0] - want[0]).abs().max().item()
    iou_eq = torch.equal(got[0], want[0])
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = iou_eq and same
    err = err_iou
    if full:
        err_tgt = (got[1] - want[1]).abs().max().item()
        rel_tgt = ((got[1] - want[1]).abs()
                   / want[1].abs().clamp(min=1.0)).max().item()
        best_eq = torch.equal(got[2], want[2])
        ok = ok and rel_tgt <= 1e-5 and best_eq
        err = max(err, err_tgt)
        log(f"[kernels] K4 {label} full: max_iou equal to plain {iou_eq}, "
            f"targets err {err_tgt:.3g} (tol 1e-5 relative, got "
            f"{rel_tgt:.3g}), best anchor equal {best_eq}, two calls equal "
            f"{same}")
    else:
        log(f"[kernels] K4 {label} max-only: max_iou equal to plain "
            f"{iou_eq}, two calls equal {same}")
    if not ok:
        raise AssertionError(f"K4 disagrees with plain at {label}")
    del got, want, again
    pairs = b * n * i
    ops = (20.0 if full else 16.0) * pairs
    nbytes = n * 16 + b * i * 17 + b * n * 4 + (
        b * n * 16 + b * i * 8 if full else 0)
    bms, bby = bound(nbytes, ops)
    case = dict(
        name="match_anchors",
        shape=dict(B=b, N=n, I=i, full=full, valid=int(v.sum()), case=label),
        max_err=err, tol=0.0 if not full else 1e-5,
        ms=time_ms(lambda: cm.match_anchors(anchors, gt, v, full), runs=11),
        plain_ms=time_ms(
            lambda: cm.match_anchors_plain(anchors, gt, v, full),
            warmup=1, runs=3, calls=2),
        library_ms=None,
        kernel_ms=kernel_ms(lambda: cm.match_anchors(anchors, gt, v, full),
                            cm.match_kernels(b, n, i, full)),
        bound_ms=bms, bound_by=bby, bytes=nbytes, operations=ops,
        two_calls_equal=same, equal_to_plain=iou_eq)
    torch.cuda.empty_cache()
    return case



def spans_check(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A kernel pre-pass's spans [..., 4] (y_lo, y_hi, x_lo, x_hi) against
    the plain ones: wherever the plain span has taps on both axes, the
    kernel's must cover it (wider is allowed, a missed tap is not)."""
    got, want = got.cpu(), want.cpu()
    live = (want[..., 0] <= want[..., 1]) & (want[..., 2] <= want[..., 3])
    covers = (got[..., 0] <= want[..., 0]) & (got[..., 1] >= want[..., 1]) \
        & (got[..., 2] <= want[..., 2]) & (got[..., 3] >= want[..., 3])
    return dict(spans_cover=bool((covers | ~live).all()),
                spans_equal=torch.equal(got, want), rois_with_taps=int(
                    live.sum()))


def k3_case(cra, rois: torch.Tensor, dtype, gen: torch.Generator,
            label: str = "") -> dict:
    """K3 on boxes [B, K, 4] over the 56x76x256 map, with K1's weights
    and a random output gradient: k3_check."""
    b, k = rois.shape[:2]
    wy, wx = cra.roi_weights(rois, (H, W), OUT, RATIO, SCALE, dtype)
    g = torch.randn((b, k, OUT, OUT, C), generator=gen).to(rois.device,
                                                          dtype)
    return k3_check(cra, g, wy, wx, (H, W), label)


def k3_check(cra, g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
             hw: tuple, label: str = "") -> dict:
    """K3 (its spans pre-pass and main kernel) against its plain version
    and its library yardstick on an output gradient g [B, K, n, n, C] and
    K1's weights for an [H, W] map: checked (tolerance, covering spans,
    two calls equal bit for bit) and timed."""
    b, k = g.shape[:2]
    c = g.shape[-1]
    dtype = g.dtype
    name = f"{label + ' ' if label else ''}B={b} K={k} " \
        f"{str(dtype).split('.')[-1]}"
    got = cra.roi_align_bwd(g, wy, wx, hw)
    again = cra.roi_align_bwd(g, wy, wx, hw)
    ref = cra.roi_align_bwd_plain(g, wy, wx, hw)
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # bf16: u and dF are rounded to bf16 in both after f32 sums in
    # another order, which can flip a rounding: 2 bf16 ulps at the
    # output's magnitude. f32: reassociation of the sums over ROIs and
    # bins, 1e-5 relative.
    tol = (2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
        * max(scale, 1.0)
    lib = k3_library(g, wy, wx)
    err_lib = (lib.float() - ref.float()).abs().max().item()
    # The library call contracts in the input dtype with its own
    # intermediates: bf16 within 2^-5 of max|dF|, f32 1e-5.
    tol_lib = (2.0 ** -5 if dtype == torch.bfloat16 else 1e-5) \
        * max(scale, 1.0)
    spans = spans_check(cra.roi_spans(wy, wx), cra.roi_spans_plain(wy, wx))
    same = torch.equal(got, again)
    blocks = cra.roi_align_bwd_blocks_per_sm(dtype)
    torch.cuda.synchronize()
    log(f"[kernels] K3 {name}: max_err {diff:.3g} (tol {tol:.3g}); "
        f"library einsum vs plain {err_lib:.3g} (tol {tol_lib:.3g}); "
        f"{json.dumps(spans)}; two calls equal {same}; blocks/SM {blocks}")
    if not (diff <= tol and err_lib <= tol_lib and spans["spans_cover"]
            and same and blocks >= 2):
        raise AssertionError(f"K3 disagrees at {name}")
    del lib, ref, again
    esz = g.element_size()
    nbytes = (g.numel() + wy.numel() + wx.numel() + b * hw[0] * hw[1] * c) \
        * esz
    ops = k3_operations(wy, wx, c)
    bms, bby = bound(nbytes, ops)
    case = dict(
        name="roi_align_bwd",
        shape=dict(B=b, H=hw[0], W=hw[1], C=c, K=k, dtype=str(dtype),
                   case=label),
        max_err=diff, tol=tol,
        ms=time_ms(lambda: cra.roi_align_bwd(g, wy, wx, hw)),
        plain_ms=time_ms(lambda: cra.roi_align_bwd_plain(g, wy, wx, hw),
                         warmup=1, runs=5, calls=2),
        library_ms=time_ms(lambda: k3_library(g, wy, wx), runs=11),
        library_err=err_lib, library_tol=tol_lib,
        kernel_ms=kernel_ms(lambda: cra.roi_align_bwd(g, wy, wx, hw),
                            ("roi_spans_kernel", "roi_align_bwd_kernel")),
        bound_ms=bms, bound_by=bby, bytes=nbytes, operations=ops,
        two_calls_equal=same, blocks_per_sm=blocks, **spans)
    del got, g, wy, wx
    torch.cuda.empty_cache()
    return case


def phase_train_kernels(cra, cm) -> list:
    """K4 (full and max-only), K3 (bf16 and f32), and K1/K2 (bf16) against
    their plain versions at the training shapes."""
    from livecell_tpu_torch.ops.anchors import generate_anchors
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    anchors = torch.from_numpy(generate_anchors((H, W))).to(dev)
    n = anchors.shape[0]
    boxes, valid, _ = train_gt(32, 128, rng)
    cases = []
    # K4: fixed mode (32 images x 128 slots), quirk mode (1 "image" of
    # the 4,096 slots concatenated), and the fixed mode's worst case,
    # every slot holding a valid box (the kernel's work grows with them).
    full_gt, _, _ = train_gt(32, 128, rng, n_inst=128)
    for label, gt, v in (
            ("fixed B=32 I=128", boxes, valid),
            ("quirk B=1 I=4096", boxes.reshape(1, -1, 4),
             valid.reshape(1, -1)),
            ("fixed all valid B=32 I=128", full_gt,
             np.ones_like(valid))):
        gt = torch.from_numpy(gt).to(dev)
        v = torch.from_numpy(v).to(dev)
        for full in (True, False):
            cases.append(k4_case(cm, anchors, gt, v, full, label))
    # K3 at the training RoIAlign shapes: fixed mode [32, 128] and quirk
    # mode [1, 128] proposals on the 56x76x256 map, then one box covering
    # the whole map.
    gen = torch.Generator().manual_seed(SEED + 2)
    for b in (32, 1):
        rois = torch.cat([make_boxes(128, gen) for _ in range(2)])[:b]
        rois = rois.contiguous().to(dev)
        if b == 32:
            # K1 and K2 at the fixed mode's training shape.
            feat = torch.randn((b, H, W, C), generator=gen).to(
                dev, torch.bfloat16)
            cases += k12_cases(cra, feat, rois)
            del feat
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(k3_case(cra, rois, dtype, gen))
    whole = torch.tensor([[[0.0, 0.0, 4.0 * W, 4.0 * H]]], device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(k3_case(cra, whole, dtype, gen, "whole map"))
    for c in cases:
        log("[kernels]", json.dumps({k: v for k, v in c.items()}))
    return cases


# The training configurations, on top of ModelConfig() (bf16 compute):
# T1 the reference's quirk mode, T2 the flagship fixed mode
# (--fixed_heads --decode_proposals --mask_samples 64).
TRAIN_CFGS = {"T1": {},
              "T2": dict(heads_all_images=True, decode_proposals=True,
                         mask_train_samples=64)}
TRAIN_B, POOL_TILES = 32, 128
WARMUP_STEPS, TIMED_STEPS = 3, 10


def train_counters() -> dict:
    """The launch counters of the four kernels of a training step."""
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    return {"roi_weights": cra.roi_weights,
            "roi_align_fwd": cra.roi_align_fwd,
            "roi_align_bwd": cra.roi_align_bwd,
            "match_anchors": cm.match_anchors}


def make_pool(cfg, n: int, dev, seed: int):
    """bench.py's synthetic training batch as a pool on `dev`: uint8
    images, 40 boxes of 20-55 px per tile in max_instances slots, uint8
    mask28 (train_gt: one tile with duplicate GT, one without GT)."""
    from livecell_tpu_torch.data.device_data import DeviceDataset
    rng = np.random.default_rng(seed)
    h, w = cfg.image_height, cfg.image_width
    images = (rng.uniform(size=(n, h, w, 3)) * 255).astype(np.uint8)
    boxes, valid, mask28 = train_gt(n, cfg.max_instances, rng, h, w)
    return DeviceDataset(images, {"boxes": boxes, "valid": valid,
                                  "labels": valid.astype(np.int32),
                                  "mask28": mask28}, device=dev)


def phase_train(label: str, cfg, pool, batch: int, dev,
                profile: bool = True):
    """WARMUP_STEPS then TIMED_STEPS training steps through train_epoch
    at `batch`, from weights of the seed. The launch counters are zeroed
    just before the timed steps and read just after: each of K1-K4 must
    run once per step. Returns (result, trained model, optimizer)."""
    from livecell_tpu_torch.data.device_data import epoch_indices, train_epoch
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.parallel.train_step import (
        build_optimizer, make_step_fn)
    from livecell_tpu_torch.utils.profiling import sync

    model = create_train_model(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    idx = epoch_indices(len(pool), batch, seed=SEED)
    opt = build_optimizer(model, 1e-3, 1e-4, steps_per_epoch=len(idx))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = np.arange(WARMUP_STEPS + TIMED_STEPS) % len(idx)
    warm = train_epoch(model, opt, pool, idx[rows[:WARMUP_STEPS]], gen)
    sync(dev)
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    m = train_epoch(model, opt, pool, idx[rows[WARMUP_STEPS:]], gen)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = np.concatenate([warm["total_loss"], m["total_loss"]])
    res = dict(config=label, batch=batch, steps=TIMED_STEPS,
               step_ms=dt / TIMED_STEPS * 1e3,
               img_per_s=batch * TIMED_STEPS / dt,
               first_total_loss=float(losses[0]),
               last_total_loss=float(losses[-1]),
               grad_norm=float(m["grad_norm"][-1]),
               losses={k: float(v[-1]) for k, v in m.items()
                       if k.startswith("loss_")},
               launches_per_step={k: v / TIMED_STEPS
                                  for k, v in launches.items()})
    log(f"[train {label}]", json.dumps(res))
    if not (np.isfinite(losses).all() and np.isfinite(m["grad_norm"]).all()):
        raise AssertionError(f"{label}: non-finite loss or grad norm")
    if dev != "cpu" and launches != {k: TIMED_STEPS for k in launches}:
        raise AssertionError(f"{label}: launches {launches}, expected one "
                             f"per step of each kernel")
    if profile:
        step = make_step_fn(model, opt)
        images, targets = pool.batch(torch.as_tensor(
            idx[0], dtype=torch.long, device=pool.images.device))
        res["profile"] = profile_call(
            lambda: step(images, targets, generator=gen))
        log(f"[profile {label}]", json.dumps(res["profile"]))
    return res, model, opt


def phase_train_e2e(cfg, pool, batch: int, dev) -> dict:
    """One f32 training step from the same weights, batch and draws with
    the kernels (roi_backend and match_backend "kernel") and with their
    plain versions: the sampled selections must be equal, the losses and
    every parameter's gradient close. The kernel route runs twice, so
    the kernel-vs-kernel spread shows the run-to-run noise."""
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.parallel.train_step import (
        build_optimizer, make_step_fn)

    images, targets = pool.batch(
        torch.arange(batch, device=pool.images.device))
    torch.backends.cudnn.deterministic = True
    runs = []
    for backend in ("kernel", "plain", "kernel"):
        route = "kernel" if backend == "kernel" and dev != "cpu" else "plain"
        c = dataclasses.replace(cfg, compute_dtype="float32",
                                roi_backend=route, match_backend=route)
        model = create_train_model(c, torch.Generator().manual_seed(SEED),
                                   device=dev)
        opt = build_optimizer(model, 1e-3, 1e-4, 1)
        record = {}
        m = make_step_fn(model, opt)(
            images, targets, record=record,
            generator=torch.Generator(device=dev).manual_seed(SEED + 5))
        runs.append((m, record, {n: p.grad.clone()
                                 for n, p in model.named_parameters()}))
        del model, opt
    torch.backends.cudnn.deterministic = False
    (mk, rk, gk), (mp, rp, gp), (_, _, gk2) = runs
    same = {k: torch.equal(rk[k], rp[k]) for k in rp}

    def worst(ga, gb):
        """Largest per-tensor |a - b| / max|b| and the tensor's name."""
        return max(((ga[n] - gb[n]).abs().max().item()
                    / max(gb[n].abs().max().item(), 1e-12), n) for n in gb)

    loss_err = max(abs(mk[k].item() - mp[k].item()) / max(abs(mp[k].item()),
                                                           1e-6)
                   for k in mp if k.startswith("loss_"))
    g_err, g_name = worst(gk, gp)
    spread, _ = worst(gk2, gk)
    res = dict(batch=batch, selections_equal=same, loss_rel_err=loss_err,
               grad_rel_err=g_err, grad_worst=g_name,
               kernel_vs_kernel_grad_rel=spread,
               losses_kernel={k: mk[k].item() for k in mk},
               losses_plain={k: mp[k].item() for k in mp})
    log("[train e2e f32]", json.dumps(res))
    # Tolerances: the kernels agree with their plain versions bit for bit
    # (K1, K4's IoU) or within f32 reassociation (K2, K3: ~1e-7 of the
    # scale); the losses are sums over the same selections, 1e-5
    # relative. Gradients pass those differences, and the order of
    # cuDNN's and the atomics' f32 sums, back through ~20 layers of
    # train-mode batch norm: 1e-3 of each tensor's largest entry.
    if not (all(same.values()) and loss_err <= 1e-5 and g_err <= 1e-3):
        raise AssertionError(f"train e2e: kernel and plain disagree: {res}")
    return res


def phase_checkpoint(model, opt, dev, tile: np.ndarray) -> dict:
    """Save the trained model with train/checkpoint.py, load it with
    serve/app.py:load_model and serve one tile through InferenceEngine;
    the served weights are the trained ones cast to the serving dtype."""
    import tempfile

    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve.app import InferenceEngine, load_model
    from livecell_tpu_torch.train import checkpoint
    from livecell_tpu_torch.utils.profiling import sync

    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save(tmp + "/ckpt", model, opt, epoch=1)
        served = load_model(path, device=dev)
    trained = model.state_dict()
    for k, v in served.state_dict().items():
        if not torch.equal(v, trained[k].to(v.dtype)):
            raise AssertionError(f"checkpoint: {k} differs after loading")
    cra.roi_weights.launches = cra.roi_align_fwd.launches = 0
    boxes, scores, masks = InferenceEngine(model=served, device=dev).predict(
        tile, score_threshold=0.0)
    sync(dev)
    res = dict(detections=len(boxes), launches={
        "roi_weights": cra.roi_weights.launches,
        "roi_align_fwd": cra.roi_align_fwd.launches})
    log("[checkpoint]", json.dumps(res))
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()
            and masks.shape == (len(boxes),) + tile.shape[:2]):
        raise AssertionError("checkpoint: malformed output")
    # One RoIAlign per forward, two with decode_proposals (the second
    # mask pass at the refined boxes).
    per_fwd = 2 if served.cfg.decode_proposals else 1
    if dev != "cpu" and res["launches"] != {"roi_weights": per_fwd,
                                            "roi_align_fwd": per_fwd}:
        raise AssertionError(f"checkpoint: launches {res['launches']}")
    return res


def phase_serve_e2e(cfg, tcfg, frame: np.ndarray) -> dict:
    """Request (a)'s forward in f32 with roi_backend "kernel" and "plain",
    from the same weights: valid equal; boxes, scores and mask
    probabilities within 1e-3."""
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.serve.stitch import tile_position

    tiles = np.zeros((tcfg.num_tiles, cfg.image_height, cfg.image_width, 3),
                     np.float32)
    for t in range(tcfg.num_tiles):
        c0, r0 = tile_position(t, tcfg.tiles_per_row)
        x0, y0 = c0 * tcfg.mini_tile_width, r0 * tcfg.mini_tile_height
        tiles[t, :tcfg.tile_height, :tcfg.tile_width] = frame[
            y0:y0 + tcfg.tile_height, x0:x0 + tcfg.tile_width] / 255.0
    x = torch.from_numpy(tiles).cuda()
    dets = {}
    for backend in ("kernel", "plain"):
        m = create_model(dataclasses.replace(
            cfg, compute_dtype="float32", roi_backend=backend),
            torch.Generator().manual_seed(SEED))
        dets[backend] = m.inference_forward(x)
        del m
    dk, dp = dets["kernel"], dets["plain"]
    if not torch.equal(dk.valid, dp.valid):
        raise AssertionError("e2e: valid differs between kernel and plain")
    v = dk.valid
    e2e = {f: (getattr(dk, f)[v].float() - getattr(dp, f)[v].float())
           .abs().max().item() if v.any() else 0.0
           for f in ("boxes", "scores", "mask_probs")}
    log(f"[e2e f32] valid {int(v.sum())} of {v.numel()}; max abs diff "
        f"{json.dumps(e2e)} (tol 1e-3)")
    if not (v.any() and max(e2e.values()) <= 1e-3):
        raise AssertionError(f"e2e: kernel and plain disagree: {e2e}")
    return e2e


def synthetic_frame(h: int, w: int, seed: int) -> np.ndarray:
    """Gray background with noise and ~120 bright elliptic 'cells'."""
    rng = np.random.default_rng(seed)
    img = rng.normal(60, 8, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(120):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(5, 16, 2)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] += \
            rng.uniform(80, 150)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def serve(engine, image, counters, expect_fwd, label):
    """First request with the counters zeroed just before it, then
    steady-state latency over 5 more."""
    cra = counters
    cra.roi_weights.launches = 0
    cra.roi_align_fwd.launches = 0
    t0 = time.perf_counter()
    boxes, scores, masks = engine.predict(image, score_threshold=0.0)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    launches = {"roi_weights": cra.roi_weights.launches,
                "roi_align_fwd": cra.roi_align_fwd.launches}
    if launches != {"roi_weights": expect_fwd, "roi_align_fwd": expect_fwd}:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect_fwd} per kernel")
    h, w = image.shape[:2]
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()
            and masks.shape == (len(boxes), h, w)
            and ((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"{label}: malformed output")
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.predict(image, score_threshold=0.0)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    res = dict(request=label, first_ms=first,
               steady_ms=statistics.median(steady), detections=len(boxes),
               launches=launches)
    log("[serve]", json.dumps(res))
    return res


def profile_call(fn) -> dict:
    """One call of `fn` traced (tools/trace_summary.summarize_call): its
    wall time, the device busy time (the union of its device events) and
    the share of the wall time the device sat idle, the kernel launches,
    and the kernels that took the most."""
    from livecell_tpu_torch.tools import trace_summary
    s = trace_summary.summarize_call(fn)
    return dict(wall_ms=s["wall_ms"], device_busy_ms=s["busy_ms"],
                idle_share=max(0.0, 1.0 - s["busy_ms"] / s["wall_ms"]),
                kernel_launches=s["launches"],
                top=[dict(name=k[:70], device_ms=us / 1e3)
                     for k, us, _ in s["top"][:10]])


def profile_request(engine, image) -> dict:
    """profile_call over one steady request."""
    return profile_call(lambda: engine.predict(image, score_threshold=0.0))


# ---------------------------------------------------------------------------
# The transfer slice (phases 9-12).
# ---------------------------------------------------------------------------
# P2..P5 of the 800x1088 canvas, 256 channels.
T_PYRAMID = ((200, 272), (100, 136), (50, 68), (25, 34))
T_BATCH, T_POOL = 4, 16
# tests/test_pallas_ms_roi.py:76-96's elongated boxes, on the canvas.
T_ELONGATED = [[16.0, 40.0, 1000.0, 72.0], [120.0, 8.0, 152.0, 620.0],
               [0.0, 0.0, 1086.0, 800.0], [400.0, 200.0, 560.0, 360.0]]
# One box covering the whole canvas: its ROI pools from P5, so P2-P4 get
# no ROI and an all-zero gradient.
T_WHOLE = [[0.0, 0.0, 1088.0, 800.0]]


def transfer_boxes(b: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """[B, K, 4] boxes on the 800x1086 canvas: sides log-uniform in
    [8, 900] px, aspect ratios log-uniform in [1/8, 8], centres up to 50
    px past the border, so that every level gets ROIs, thin and long
    ones too."""
    u = torch.rand((b, k, 4), generator=gen)
    side = torch.exp(math.log(8.0) + u[..., 0] * math.log(900.0 / 8.0))
    ar = torch.exp((u[..., 1] - 0.5) * 2.0 * math.log(8.0))
    bw, bh = side * ar.sqrt(), side / ar.sqrt()
    cx = u[..., 2] * 1186.0 - 50.0
    cy = u[..., 3] * 900.0 - 50.0
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       dim=-1).contiguous()


def ms_roi_cases(cms, feats: list, boxes: torch.Tensor, out_size: int,
                 label: str, time_plain: bool = True,
                 backward: bool = True) -> list:
    """K5 and (with `backward`) K6 against their plain versions on one
    pyramid and one box set, checked and timed. Bound: K5 moves its
    output, the boxes and levels, and every feature pixel a tap touches
    once; K6 reads g, the boxes and levels and writes the four maps'
    gradients whole."""
    dtype = feats[0].dtype
    esz = feats[0].element_size()
    b, k = boxes.shape[:2]
    hw = [tuple(f.shape[1:3]) for f in feats]
    levels = cms.assign_levels(boxes)
    out = cms.ms_roi_align_fwd(feats, boxes, levels, out_size)
    same5 = torch.equal(out, cms.ms_roi_align_fwd(feats, boxes, levels,
                                                  out_size))
    ref = cms.ms_roi_align_fwd_plain(feats, boxes, levels, out_size)
    # As K2: bit for bit in bf16, recorded in f32.
    exact5 = torch.equal(out, ref)
    blocks5 = cms.ms_roi_align_fwd_blocks_per_sm(dtype)
    err5 = (out.float() - ref.float()).abs().max().item()
    # K2's and K3's tolerances: bf16 rounds the row contraction (u) and
    # the output after f32 sums in another order, which can flip a
    # rounding: 2 bf16 ulps at the magnitude; f32 reassociation, 1e-5.
    rel = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    tol5 = rel * max(ref.float().abs().max().item(), 1.0)
    per_level = [int((levels == i).sum()) for i in range(4)]
    name = f"{label} B={b} K={k} s={out_size} {str(dtype).split('.')[-1]}"
    log(f"[kernels] {name} ROIs per level {per_level}: K5 max_err "
        f"{err5:.3g} (tol {tol5:.3g}), equal to plain {exact5}, two calls "
        f"equal {same5}, blocks/SM {blocks5}")
    if not (err5 <= tol5 and same5 and blocks5 >= 2
            and (exact5 or dtype != torch.bfloat16)):
        raise AssertionError(f"K5 disagrees with plain at {name}")
    if backward:
        g, same, empty_zero, spans, blocks, err6, tol6 = ms_roi_bwd_check(
            cms, out, boxes, levels, hw, out_size, per_level, name)
    del out, ref

    # What these inputs need: each level's weights (zero for the other
    # levels' ROIs), their non-zero taps and the pixels they touch.
    ops5 = ops6 = 0.0
    touched = 0
    for lvl, (h, w) in enumerate(hw):
        wy, wx = cms.level_weights(boxes, levels, lvl, (h, w), out_size, 2,
                                   dtype)
        ops5 += k2_operations(wy, wx, C)
        ops6 += k3_operations(wy, wx, C)
        rows = (wy != 0).any(dim=2).float()                # [B, K, H]
        cols = (wx != 0).any(dim=2).float()                # [B, K, W]
        touched += int((torch.einsum("bkh,bkw->bhw", rows, cols) > 0).sum())
        del wy, wx, rows, cols
    side = b * k * (16 + 4)
    bytes5 = b * k * out_size * out_size * C * esz + touched * C * esz + side
    bytes6 = b * k * out_size * out_size * C * esz + side + sum(
        b * h * w * C * esz for h, w in hw)
    shape = dict(B=b, K=k, s=out_size, C=C, dtype=str(dtype), case=label,
                 rois_per_level=per_level)
    runs = [("ms_roi_align_fwd",
             lambda: cms.ms_roi_align_fwd(feats, boxes, levels, out_size),
             lambda: cms.ms_roi_align_fwd_plain(feats, boxes, levels,
                                                out_size),
             bytes5, ops5, err5, tol5, ("ms_roi_align_fwd_kernel",),
             dict(two_calls_equal=same5, equal_to_plain=exact5,
                  blocks_per_sm=blocks5))]
    if backward:
        runs.append((
            "ms_roi_align_bwd",
            lambda: cms.ms_roi_align_bwd(g, boxes, levels, hw),
            lambda: cms.ms_roi_align_bwd_plain(g, boxes, levels, hw),
            bytes6, ops6, err6, tol6,
            ("ms_roi_spans_kernel", "ms_roi_align_bwd_kernel"),
            dict(two_calls_equal=same, empty_levels_zero=empty_zero,
                 blocks_per_sm=blocks, **spans)))
    cases = []
    for kname, fn, plain, nbytes, ops, err, tol, launched, extra in runs:
        bms, bby = bound(nbytes, ops)
        cases.append(dict(
            name=kname, shape=shape, max_err=err, tol=tol,
            ms=time_ms(fn, runs=11, calls=5),
            plain_ms=time_ms(plain, warmup=1, runs=3, calls=1)
            if time_plain else None,
            library_ms=None,
            kernel_ms=kernel_ms(fn, launched, calls=5),
            bound_ms=bms, bound_by=bby, bytes=nbytes, operations=ops,
            **extra))
        torch.cuda.empty_cache()
    return cases


def ms_roi_bwd_check(cms, out, boxes, levels, hw, out_size, per_level,
                     name):
    """K6 against its plain version on a random gradient of K5's output
    `out`: within two bf16 ulps (1e-5 in f32) of the smallest level
    gradient's magnitude, two calls equal, levels without ROIs all-zero,
    the spans pre-pass covering the plain spans. Returns (g, two calls
    equal, empty levels zero, spans, blocks/SM, max err, tol)."""
    dtype = out.dtype
    rel = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    g = torch.randn(out.shape, device=out.device).to(dtype)
    dfs = cms.ms_roi_align_bwd(g, boxes, levels, hw)
    again = cms.ms_roi_align_bwd(g, boxes, levels, hw)
    drefs = cms.ms_roi_align_bwd_plain(g, boxes, levels, hw)
    err6 = max((d.float() - r.float()).abs().max().item()
               for d, r in zip(dfs, drefs))
    tol6 = min(rel * max(r.float().abs().max().item(), 1.0) for r in drefs)
    same = all(torch.equal(d, e) for d, e in zip(dfs, again))
    # A level without ROIs gets an all-zero gradient.
    empty_zero = all(not bool(d.any()) for d, n in zip(dfs, per_level)
                     if n == 0)
    spans = spans_check(
        cms.ms_roi_spans(boxes, levels, hw, out_size, 2, dtype),
        cms.ms_roi_spans_plain(boxes, levels, hw, out_size, 2, dtype))
    blocks = cms.ms_roi_align_bwd_blocks_per_sm(dtype)
    torch.cuda.synchronize()
    log(f"[kernels] {name}: K6 max_err {err6:.3g} (tol {tol6:.3g}); K6 "
        f"{json.dumps(spans)}; two calls equal {same}; empty levels zero "
        f"{empty_zero}; blocks/SM {blocks}")
    if not (err6 <= tol6 and same and empty_zero and spans["spans_cover"]
            and blocks >= 2):
        raise AssertionError(f"K6 disagrees with plain at {name}")
    return g, same, empty_zero, spans, blocks, err6, tol6


def transfer_gt(b: int, slots: int, rng: np.random.Generator):
    """bench.py's transfer targets (bench.py:256-276): 40 boxes of 12-55
    px per 224x304 tile in `slots` slots, uint8 mask28."""
    boxes = np.zeros((b, slots, 4), np.float32)
    for bi in range(b):
        x1, y1 = rng.uniform(0, 304 - 60, 40), rng.uniform(0, 224 - 60, 40)
        bw, bh = rng.uniform(12, 55, 40), rng.uniform(12, 55, 40)
        boxes[bi, :40] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
    valid = np.zeros((b, slots), bool)
    valid[:, :40] = True
    mask28 = (rng.uniform(size=(b, slots, 28, 28)) > 0.5).astype(
        np.uint8) * 255
    return boxes, valid, mask28


def phase_transfer_kernels(cms, cm) -> list:
    """K5/K6 at the transfer model's training and serving shapes in bf16
    and f32 and on the elongated boxes; K4 full at 217,413 anchors."""
    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.transfer import (
        pyramid_shapes, torchvision_anchors)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    cases = []
    for label, b, shapes in (
            ("train", T_BATCH, ((512, 7), (128, 14))),
            ("serve", 25, ((1000, 7), (100, 14))),
            ("elongated", 1, ((4, 7), (4, 14))),
            ("whole", 1, ((1, 7), (1, 14)))):
        pyr32 = [torch.randn((b, h, w, C), generator=gen).to(dev)
                 for h, w in T_PYRAMID]
        for k, s in shapes:
            boxes = (torch.tensor([T_ELONGATED]) if label == "elongated"
                     else torch.tensor([T_WHOLE]) if label == "whole"
                     else transfer_boxes(b, k, gen)).to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                cases += ms_roi_cases(cms, [f.to(dtype) for f in pyr32],
                                      boxes, s, label)
        del pyr32
        torch.cuda.empty_cache()
    # K4 at the transfer model's 217,413 anchors, bench.py's batch.
    cfg = TransferConfig()
    anchors = torch.from_numpy(np.concatenate(torchvision_anchors(
        pyramid_shapes(cfg.image_height, cfg.image_width), cfg.anchor_sizes,
        cfg.anchor_ratios, cfg.level_strides))).to(dev)
    boxes, valid, _ = transfer_gt(T_BATCH, cfg.max_instances,
                                  np.random.default_rng(SEED + 3))
    scale = np.float32([cfg.resized_width / cfg.tile_width,
                        cfg.image_height / cfg.tile_height] * 2)
    cases.append(k4_case(cm, anchors, torch.from_numpy(boxes * scale).to(dev),
                         torch.from_numpy(valid).to(dev), True,
                         f"transfer B={T_BATCH} I={cfg.max_instances}"))
    for c in cases:
        log("[kernels]", json.dumps(c))
    return cases


def frame_tiles(frame: np.ndarray, tcfg) -> np.ndarray:
    """The frame's overlapping tiles [T, th, tw, 3] (serve/app.py)."""
    from livecell_tpu_torch.serve.stitch import tile_position
    tiles = np.zeros((tcfg.num_tiles, tcfg.tile_height, tcfg.tile_width, 3),
                     np.uint8)
    for t in range(tcfg.num_tiles):
        c0, r0 = tile_position(t, tcfg.tiles_per_row)
        x0, y0 = c0 * tcfg.mini_tile_width, r0 * tcfg.mini_tile_height
        patch = frame[y0:y0 + tcfg.tile_height, x0:x0 + tcfg.tile_width]
        tiles[t, :patch.shape[0], :patch.shape[1]] = patch
    return tiles


def phase_transfer_serve(frame: np.ndarray, tcfg) -> dict:
    """(d) A frame through make_frame_predictor over the full-width
    transfer model: first call with the counters zeroed just before it,
    then the steady median of 5 and one profiled request."""
    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.serve.stitch import make_frame_predictor

    cfg = TransferConfig()
    model = create_transfer_model(cfg, torch.Generator().manual_seed(SEED))
    run = make_frame_predictor(model, tcfg, score_threshold=0.0)
    tiles = frame_tiles(frame, tcfg)
    cms.ms_roi_align_fwd.launches = cms.ms_roi_align_bwd.launches = 0
    t0 = time.perf_counter()
    det = run(tiles)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    launches = {"ms_roi_align_fwd": cms.ms_roi_align_fwd.launches,
                "ms_roi_align_bwd": cms.ms_roi_align_bwd.launches}
    if launches != {"ms_roi_align_fwd": 2, "ms_roi_align_bwd": 0}:
        raise AssertionError(f"transfer serve: launches {launches}, "
                             f"expected 2 K5 per forward")
    pad = (cfg.tile_width - tcfg.tile_width, cfg.tile_height
           - tcfg.tile_height)
    if not (np.isfinite(det.boxes).all() and np.isfinite(det.scores).all()
            and det.masks.shape == (len(det.boxes), tcfg.tile_height,
                                    tcfg.tile_width)
            and ((det.scores >= 0) & (det.scores <= 1)).all()
            and (det.boxes[:, 2] <= tcfg.frame_width + pad[0] + 1e-3).all()
            and (det.boxes[:, 3] <= tcfg.frame_height + pad[1] + 1e-3).all()
            and (det.boxes >= 0).all()):
        raise AssertionError("transfer serve: malformed output")
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        run(tiles)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    res = dict(request="d: frame, transfer R50-FPN", first_ms=first,
               steady_ms=statistics.median(steady), detections=len(det.boxes),
               launches=launches, profile=profile_call(lambda: run(tiles)))
    log("[serve]", json.dumps(res))
    return res


def transfer_pool(cfg, dev):
    """T_POOL synthetic tiles (bench.py's transfer batch) on `dev`."""
    rng = np.random.default_rng(SEED + 4)
    images = (rng.uniform(size=(T_POOL, cfg.tile_height, cfg.tile_width, 3))
              * 255).astype(np.uint8)
    boxes, valid, mask28 = transfer_gt(T_POOL, cfg.max_instances, rng)
    t = {"boxes": boxes, "valid": valid, "mask28": mask28}
    return (torch.from_numpy(images).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in t.items()})


def pool_batch(pool, i: int, batch: int):
    images, targets = pool
    idx = (torch.arange(batch, device=images.device) + i * batch) % len(images)
    return images[idx], {k: v[idx] for k, v in targets.items()}


def phase_transfer_train() -> dict:
    """(T3) bench.py's transfer step: T_WARMUP + T_TIMED steps at batch 4
    from weights of the seed; the counters are zeroed just before the
    timed steps and read just after. Then one profiled step and one
    stage-1 step (backbone, FPN and RPN frozen)."""
    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.parallel.train_step import make_step_fn
    from livecell_tpu_torch.train.train_transfer import (
        FROZEN_STAGE1, stage_optimizer)

    cfg = TransferConfig()
    model = create_transfer_model(cfg, torch.Generator().manual_seed(SEED),
                                  device="cuda", train=True)
    pool = transfer_pool(cfg, "cuda")
    step = make_step_fn(model, stage_optimizer(model, 5e-3, 0.9, 0.0, False,
                                               clip_norm=10.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = [step(*pool_batch(pool, i, T_BATCH), generator=gen)
               for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    counters = {"match_anchors": cm.match_anchors,
                "ms_roi_align_fwd": cms.ms_roi_align_fwd,
                "ms_roi_align_bwd": cms.ms_roi_align_bwd}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics += [step(*pool_batch(pool, WARMUP_STEPS + i, T_BATCH),
                     generator=gen) for i in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    m = {k: np.array([float(x[k]) for x in metrics]) for k in metrics[0]}
    res = dict(config="T3", batch=T_BATCH, steps=TIMED_STEPS,
               step_ms=dt / TIMED_STEPS * 1e3,
               img_per_s=T_BATCH * TIMED_STEPS / dt,
               first_total_loss=float(m["total_loss"][0]),
               last_total_loss=float(m["total_loss"][-1]),
               grad_norm=float(m["grad_norm"][-1]),
               losses={k: float(v[-1]) for k, v in m.items()
                       if k.startswith("loss_")},
               launches_per_step={k: v / TIMED_STEPS
                                  for k, v in launches.items()})
    log("[train T3]", json.dumps(res))
    if not all(np.isfinite(v).all() for v in m.values()):
        raise AssertionError("T3: non-finite loss or grad norm")
    want = {"match_anchors": 1, "ms_roi_align_fwd": 2, "ms_roi_align_bwd": 2}
    if launches != {k: n * TIMED_STEPS for k, n in want.items()}:
        raise AssertionError(f"T3: launches {launches}, expected K4/K5/K6 "
                             f"1/2/2 per step")
    res["profile"] = profile_call(
        lambda: step(*pool_batch(pool, 0, T_BATCH), generator=gen))
    log("[profile T3]", json.dumps(res["profile"]))

    # Stage 1: the frozen parameters keep their values, the heads move.
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m1 = make_step_fn(model, stage_optimizer(
        model, 5e-3, 0.9, 5e-4, True, clip_norm=10.0))(
        *pool_batch(pool, 1, T_BATCH), generator=gen)
    moved = {n: not torch.equal(p, before[n])
             for n, p in model.named_parameters()}
    frozen_still = all(not v for n, v in moved.items()
                       if n.split(".")[0] in FROZEN_STAGE1)
    heads_moved = all(v for n, v in moved.items()
                      if n.split(".")[0] not in FROZEN_STAGE1)
    res["stage1"] = dict(total_loss=float(m1["total_loss"]),
                         grad_norm=float(m1["grad_norm"]),
                         frozen_unchanged=frozen_still,
                         heads_updated=heads_moved)
    log("[train T3 stage 1]", json.dumps(res["stage1"]))
    if not (frozen_still and heads_moved
            and all(math.isfinite(float(v)) for v in m1.values())):
        raise AssertionError(f"T3 stage 1: {res['stage1']}")
    return res


def phase_transfer_e2e() -> dict:
    """One f32 transfer step at batch 1 from the same weights, batch and
    draws with the kernels (roi_backend and rpn_match_backend "kernel")
    and with their plain versions, the kernel route twice."""
    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.parallel.train_step import make_step_fn
    from livecell_tpu_torch.train.train_transfer import stage_optimizer

    images, targets = pool_batch(transfer_pool(TransferConfig(), "cuda"),
                                 0, 1)
    torch.backends.cudnn.deterministic = True
    runs = []
    for route in ("kernel", "plain", "kernel"):
        cfg = TransferConfig(compute_dtype="float32", roi_backend=route,
                             rpn_match_backend=route)
        model = create_transfer_model(
            cfg, torch.Generator().manual_seed(SEED), device="cuda",
            train=True)
        record = {}
        m = make_step_fn(model, stage_optimizer(model, 5e-3, 0.9, 0.0,
                                                False))(
            images, targets, record=record,
            generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
        runs.append((m, record, {n: p.grad.clone()
                                 for n, p in model.named_parameters()}))
        del model
    torch.backends.cudnn.deterministic = False
    (mk, rk, gk), (mp, rp, gp), (_, _, gk2) = runs
    same = {k: torch.equal(rk[k], rp[k]) for k in rp}

    def worst(ga, gb):
        """Largest per-tensor (|a - b|_max / |b|_max, L2 of a - b / L2 of
        b), each with its tensor's name."""
        e = [((ga[n] - gb[n]).abs().max().item()
              / max(gb[n].abs().max().item(), 1e-12),
              (ga[n] - gb[n]).norm().item() / max(gb[n].norm().item(),
                                                  1e-12), n) for n in gb]
        return max((x[0], x[2]) for x in e), max((x[1], x[2]) for x in e)

    loss_err = max(abs(mk[k].item() - mp[k].item()) / max(abs(mp[k].item()),
                                                           1e-6)
                   for k in mp if k.startswith("loss_"))
    (g_max, g_name), (g_l2, g_l2_name) = worst(gk, gp)
    (spread, _), _ = worst(gk2, gk)
    res = dict(batch=1, selections_equal=same, loss_rel_err=loss_err,
               grad_rel_err=g_max, grad_worst=g_name, grad_l2_rel_err=g_l2,
               grad_l2_worst=g_l2_name, kernel_vs_kernel_grad_rel=spread,
               losses_kernel={k: mk[k].item() for k in mk},
               losses_plain={k: mp[k].item() for k in mp})
    log("[transfer e2e f32]", json.dumps(res))
    # Tolerances: K4 agrees with its plain version bit for bit, K5/K6
    # within f32 reassociation; the losses are sums over the same
    # selections, 1e-5 relative. The gradients of random weights pass
    # those differences through ReLU and max-pool kinks: as in
    # tests/test_torch_transfer.py, 1e-2 of each tensor's largest entry
    # and 2e-3 of its norm.
    if not (all(same.values()) and loss_err <= 1e-5 and g_max <= 1e-2
            and g_l2 <= 2e-3):
        raise AssertionError(f"transfer e2e: kernel and plain disagree: "
                             f"{res}")
    return res


# ---------------------------------------------------------------------------
# The data and evaluation slice (phases 13-14).
# ---------------------------------------------------------------------------
# A 15-frame split at LIVECell statistics, the size of a val or test split
# of the reference's default preprocessing (100 A172 frames, 70/15/15).
SPLIT_FRAMES, FRAME_W, FRAME_H = 15, 704, 520
EVAL_B_CUSTOM, EVAL_B_TRANSFER = 32, 4
# The "sparse" split of tools/synth_splits.py, on which the JAX package's
# quality runs were measured (STATUS.md "Round 3"): 12 cells a frame,
# 14/3/3 frames -> 350/75/75 tiles.
SPARSE_CELLS = 12
SPARSE_FRAMES = (("train", 14), ("val", 3), ("test", 3))


def draw_split(root, seed: int, mode: str = "livecell",
               frames=(("test", SPLIT_FRAMES),)) -> dict:
    """Grey frames drawn with numpy with their polygon annotations, cut
    into tiles by the port's tiler and written with its PNG encoder as
    the splits of a tiled tree under `root`: `frames` gives each split's
    frame count. The cell samplers are tools/synth_splits.py's; the
    drawing (the noise, ids counted per split) is this function's own.
    `mode` "livecell": LIVECell's statistics, cells 120-220 on 30 with
    noise of sigma 8; "sparse": 12 ellipses a frame, 120-220 on 30, no
    noise. Returns {split: {"frames": [grey frames],
    "annotations": [each frame's polygon annotations]}}."""
    from livecell_tpu_torch.data.coco import polygons_to_mask
    from livecell_tpu_torch.data.tiling import TILES_PER_IMAGE, tile_frame
    from livecell_tpu_torch.tools.synth_splits import (
        ellipse_polygon, sample_livecell_instances, sample_uniform_instances)

    rng = np.random.default_rng(seed)
    out = {}
    (root / "annotations").mkdir(parents=True)
    for split, n_frames in frames:
        drawn, frame_anns, images, tile_anns = [], [], [], []
        ann_id = 0
        for i in range(n_frames):
            canvas = np.full((FRAME_H, FRAME_W), 30.0)
            anns = []
            cells = (sample_livecell_instances(rng, FRAME_W, FRAME_H)
                     if mode == "livecell" else
                     sample_uniform_instances(rng, FRAME_W, FRAME_H,
                                              SPARSE_CELLS))
            for cx, cy, rx, ry, theta in cells:
                poly = ellipse_polygon(cx, cy, rx, ry, theta=theta)
                canvas[polygons_to_mask([poly], FRAME_H, FRAME_W) > 0] = \
                    rng.uniform(120, 220)
                xs, ys = poly[0::2], poly[1::2]
                x1, y1 = max(min(xs), 0), max(min(ys), 0)
                x2, y2 = min(max(xs), FRAME_W), min(max(ys), FRAME_H)
                if x2 - x1 < 1 or y2 - y1 < 1:
                    continue
                ann_id += 1
                anns.append({"id": ann_id, "image_id": i + 1,
                             "category_id": 1,
                             "bbox": [x1, y1, x2 - x1, y2 - y1],
                             "area": (x2 - x1) * (y2 - y1),
                             "segmentation": [poly], "iscrowd": 0})
            if mode == "livecell":
                canvas += rng.normal(0.0, 8.0, canvas.shape)
            frame = np.clip(np.rint(canvas), 0, 255).astype(np.uint8)
            drawn.append(frame)
            frame_anns.append(anns)
            info = {"id": i + 1,
                    "file_name": f"A172_Phase_{split}_{i:03d}.tif",
                    "width": FRAME_W, "height": FRAME_H}
            for rec in tile_frame(frame, info, anns, root / split / "images",
                                  i * TILES_PER_IMAGE):
                images.append({k: rec[k] for k in
                               ("id", "file_name", "width", "height")})
                tile_anns += rec["annotations"]
        with open(root / "annotations" / f"livecell_coco_{split}.json",
                  "w") as f:
            f.write(json.dumps({"images": images, "annotations": tile_anns,
                                "categories": [{"id": 1, "name": "cell"}]}))
        out[split] = {"frames": drawn, "annotations": frame_anns}
    return out


def phase_data(root) -> tuple:
    """13. A 375-tile split drawn, tiled and written (C++ raster), packed
    on the card and on the CPU, and held on the card: the decoded tiles
    must equal the drawn pixels bit for bit, the card's mask targets the
    CPU's within the CPU tests' bound (one count of 1/255 on at most 0.1%
    of the entries, tests/test_torch_dataset.py). Returns (result, the
    card's PackedDataset, its DeviceDataset)."""
    from livecell_tpu_torch import native
    from livecell_tpu_torch.config import ModelConfig
    from livecell_tpu_torch.data.dataset import PackedDataset
    from livecell_tpu_torch.data.device_data import DeviceDataset
    from livecell_tpu_torch.data.tiling import (
        TILES_PER_IMAGE, tile_coordinates, tile_grid)
    from livecell_tpu_torch.ops.mask_ops import extract_mask_targets

    if native.backend() != "cpp":
        raise AssertionError("data: the C++ rasterizer did not build")
    t0 = time.perf_counter()
    frames = draw_split(root, SEED + 13)["test"]["frames"]
    draw_s = time.perf_counter() - t0

    # The mask-target precompute, timed by CUDA events around it (the
    # host's rasterization of each chunk included).
    spans = []
    real = PackedDataset._compute_mask28

    def timed(self, *args):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = real(self, *args)
        e.record()
        torch.cuda.synchronize()
        spans.append(s.elapsed_time(e))
        return out

    cfg = ModelConfig()
    PackedDataset._compute_mask28 = timed
    try:
        t0 = time.perf_counter()
        pds = PackedDataset(str(root), "test", cfg, cache=False,
                            device="cuda")
        pack_s = time.perf_counter() - t0
    finally:
        PackedDataset._compute_mask28 = real
    t0 = time.perf_counter()
    cpu = PackedDataset(str(root), "test", cfg, cache=False, device="cpu")
    pack_cpu_s = time.perf_counter() - t0

    n_tiles = SPLIT_FRAMES * TILES_PER_IMAGE
    grid = int(math.sqrt(TILES_PER_IMAGE)) + 2
    coords = tile_coordinates(grid, *tile_grid(FRAME_W, FRAME_H, grid))
    want = np.stack([np.repeat(f[y0:y1, x0:x1, None], 3, axis=2)
                     for f in frames for x0, y0, x1, y1 in coords])
    pixels_equal = bool(len(pds) == n_tiles
                        and np.array_equal(pds.images, want))
    diff = np.abs(pds.mask28.astype(np.int16) - cpu.mask28.astype(np.int16))
    same_arrays = all(np.array_equal(getattr(pds, k), getattr(cpu, k))
                      for k in ("images", "boxes", "labels", "offsets",
                                "image_ids"))

    # The extraction alone on the card: one chunk of 256 instances.
    from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
    coco = CocoIndex(pds.ann_file)
    anns = [a for i in pds.image_ids for a in coco.get_anns(int(i))][:256]
    dense = torch.from_numpy(np.stack([ann_to_mask(a, *pds.tile_hw)
                                       for a in anns])).cuda()
    boxes = torch.from_numpy(pds.boxes[:256]).cuda()
    chunk_ms = time_ms(lambda: extract_mask_targets(dense, boxes), runs=5,
                       calls=5)
    del dense, boxes

    t0 = time.perf_counter()
    dd = DeviceDataset.from_packed(pds, device="cuda")
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    rows = np.arange(5) * (len(pds) // 5)
    images, targets = dd.batch(torch.from_numpy(rows).cuda())
    gathered = pds.gather(rows)
    resident = bool(torch.equal(images.cpu(), torch.from_numpy(gathered[0]))
                    and all(torch.equal(targets[k].cpu(),
                                        torch.from_numpy(v))
                            for k, v in gathered[1].items()))
    res = dict(frames=SPLIT_FRAMES, tiles=len(pds),
               instances=int(len(pds.boxes)),
               max_per_tile=int(pds.instance_counts().max()),
               draw_and_tile_s=draw_s, pack_s=pack_s,
               mask28_ms=sum(spans), mask28_chunks=math.ceil(
                   len(pds.boxes) / 256), extract_256_ms=chunk_ms,
               pack_cpu_s=pack_cpu_s, pixels_equal=pixels_equal,
               cpu_arrays_equal=same_arrays,
               mask28_max_count_diff=int(diff.max()),
               mask28_diff_share=float((diff > 0).mean()),
               device_nbytes=dd.nbytes, put_s=put_s, resident_equal=resident)
    log("[data]", json.dumps(res))
    if not (pixels_equal and same_arrays and resident and diff.max() <= 1
            and (diff > 0).mean() <= 1e-3 and len(spans) == 1):
        raise AssertionError(f"data: {res}")
    return res, pds, dd


def near_gt_eval_step(pds, b: int, dev: str):
    """An eval step whose detections (on `dev`) are the split's GT boxes
    jittered by ~2 px with their mask targets as masks, plus 8 random
    boxes a tile, batch after batch of pds.batches(b): COCO AP on it is
    far from 0."""
    rng = np.random.default_rng(SEED + 14)
    order = iter(range(0, len(pds), b))

    def step(images):
        tiles = (np.arange(b) + next(order)) % len(pds)
        d = 100
        boxes = np.zeros((b, d, 4), np.float32)
        probs = np.zeros((b, d, 28, 28), np.float32)
        valid = np.zeros((b, d), bool)
        for bi, t in enumerate(tiles):
            lo, hi = pds.offsets[t], pds.offsets[t + 1]
            n = min(hi - lo, d - 8)
            boxes[bi, :n] = pds.boxes[lo:lo + n] + rng.normal(0, 2, (n, 4))
            probs[bi, :n] = pds.mask28[lo:lo + n] / 255.0
            xy = rng.uniform(0, 250, (8, 2))
            boxes[bi, n:n + 8] = np.concatenate([xy, xy + 20], 1)
            probs[bi, n:n + 8] = rng.uniform(size=(8, 28, 28))
            valid[bi, :n + 8] = True
        from livecell_tpu_torch.models.detector import Detections
        return Detections(
            boxes=torch.from_numpy(boxes).to(dev),
            scores=torch.from_numpy(rng.uniform(0.1, 1, (b, d)).astype(
                np.float32)).to(dev),
            labels=torch.ones((b, d), dtype=torch.int32, device=dev),
            valid=torch.from_numpy(valid).to(dev),
            mask_probs=torch.from_numpy(probs).to(dev))

    return step


def eval_counters() -> dict:
    """The launch counters of the kernels of the two models' inference
    forwards."""
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    return {"roi_weights": cra.roi_weights,
            "roi_align_fwd": cra.roi_align_fwd,
            "ms_roi_align_fwd": cms.ms_roi_align_fwd}


def evaluate_model(label: str, model, pds, batch: int) -> dict:
    """evaluate_coco_multi (segm and bbox, box metrics) and
    metrics.evaluate over the split, with the launch counters zeroed just
    before each and read just after, the split's GT masks rasterized
    anew (a cold evaluation). The wall time of evaluate_coco_multi is
    split (host clock, each part ended by a synchronize, as its caller
    fetches the result at once) into the model's forwards, the per-tile
    paste and mask IoU on the card, the host's GT rasterization, the
    host AP code (ranking, matching, AP) and the rest; one eval batch's
    forward is profiled for the card's busy share."""
    from livecell_tpu_torch.parallel.train_step import make_eval_step
    from livecell_tpu_torch.train import coco_eval, metrics

    run = make_eval_step(model)
    counters = eval_counters()
    parts = {"forward": 0.0, "fused_mask_iou": 0.0, "_gt_packed": 0.0,
             "compute_ap": 0.0}
    real = {k: getattr(coco_eval, k) for k in parts if k != "forward"}

    def timed(name, fn):
        def wrapped(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            return out
        return wrapped

    step = timed("forward", run)
    pds.__dict__.pop("_gt_mask_cache", None)
    for fn in counters.values():
        fn.launches = 0
    for k, fn in real.items():
        setattr(coco_eval, k, timed(k, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aps = coco_eval.evaluate_coco_multi(
            step, pds, batch, iou_types=("segm", "bbox"), box_metrics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, fn in real.items():
            setattr(coco_eval, k, fn)
    launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    box = metrics.evaluate(run, pds, batch)
    box_s = time.perf_counter() - t0
    box_launches = {k: fn.launches for k, fn in counters.items()}
    images = next(pds.batches(batch))[0]
    res = dict(label=label, batch=batch,
               batches=math.ceil(len(pds) / batch), eval_s=wall,
               tiles_per_s=len(pds) / wall,
               host_ap_share=parts["compute_ap"] / wall,
               parts_s=dict(parts, other=wall - sum(parts.values())),
               launches=launches, box_eval_launches=box_launches,
               box_eval_s=box_s, ap=aps, box_metrics=box,
               forward_profile=profile_call(lambda: run(images)))
    log("[eval]", json.dumps(res))
    return res


def phase_eval(pds) -> dict:
    """14. Both full-width models, seed-0 weights, served in bf16, over
    the 375-tile split with roi_backend "kernel" and "plain": AP, AP50
    and AP75 of both IoU types and the box metrics must agree within
    1e-6 (K1, K2 and K5 equal their plain versions bit for bit in bf16,
    so any gap is a fault), K1/K2 must run once per custom batch and K5
    twice per transfer batch on the kernel route, none on the plain one;
    the card's IoU path must give the CPU's AP on detections near the GT;
    K1/K2 and K5 against their plain versions at the eval batches'
    shapes."""
    from livecell_tpu_torch.config import ModelConfig, TransferConfig
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.train import coco_eval

    # The card's unpack, paste and IoU against the CPU's, at full size,
    # on detections that overlap the GT.
    near = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        near[dev] = coco_eval.evaluate_coco_multi(
            near_gt_eval_step(pds, EVAL_B_CUSTOM, dev), pds, EVAL_B_CUSTOM,
            device=dev)
        near[dev + "_s"] = time.perf_counter() - t0
    log("[eval] near-GT detections, card vs CPU:", json.dumps(near))
    if not (near["cuda"]["segm"]["AP"] > 0.2 and all(
            abs(near["cuda"][t][k] - near["cpu"][t][k]) <= 1e-6
            for t in ("segm", "bbox") for k in ("AP", "AP50", "AP75"))):
        raise AssertionError(f"eval: card and CPU disagree: {near}")

    cases = []
    gen = torch.Generator().manual_seed(SEED + 14)
    feat = torch.randn((EVAL_B_CUSTOM, H, W, C), generator=gen).cuda()
    boxes = torch.cat([make_boxes(50, gen) for _ in range(2)])[
        :EVAL_B_CUSTOM].contiguous().cuda()
    cases += k12_cases(cra, feat.to(torch.bfloat16), boxes)
    del feat
    pyr = [torch.randn((EVAL_B_TRANSFER, h, w, C), generator=gen).cuda()
           .to(torch.bfloat16) for h, w in T_PYRAMID]
    for k, s in ((1000, 7), (100, 14)):
        cases += ms_roi_cases(cms, pyr, transfer_boxes(
            EVAL_B_TRANSFER, k, gen).cuda(), s, "eval")
    del pyr
    torch.cuda.empty_cache()
    for c in cases:
        log("[kernels]", json.dumps(c))

    n_gt = int(np.minimum(pds.instance_counts(),
                          ModelConfig().max_instances).sum())
    torch.backends.cudnn.deterministic = True
    runs = {}
    for label, build, batch in (
            ("custom", lambda r: create_model(
                ModelConfig(roi_backend=r),
                torch.Generator().manual_seed(SEED)), EVAL_B_CUSTOM),
            ("transfer", lambda r: create_transfer_model(
                TransferConfig(roi_backend=r),
                torch.Generator().manual_seed(SEED)), EVAL_B_TRANSFER)):
        for route in ("kernel", "plain"):
            model = build(route)
            runs[label, route] = evaluate_model(f"{label} {route}", model,
                                                pds, batch)
            del model
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    out = {"cases": cases}
    for label, batch in (("custom", EVAL_B_CUSTOM),
                         ("transfer", EVAL_B_TRANSFER)):
        k, p = runs[label, "kernel"], runs[label, "plain"]
        nb = math.ceil(len(pds) / batch)
        per = ({"roi_weights": nb, "roi_align_fwd": nb,
                "ms_roi_align_fwd": 0} if label == "custom" else
               {"roi_weights": 0, "roi_align_fwd": 0,
                "ms_roi_align_fwd": 2 * nb})
        gaps = [abs(k["ap"][t][m] - p["ap"][t][m])
                for t in ("segm", "bbox") for m in ("AP", "AP50", "AP75")]
        gaps += [abs(k["ap"]["box_metrics"][m] - p["ap"]["box_metrics"][m])
                 for m in k["ap"]["box_metrics"]]
        zero = {n: 0 for n in per}
        ok = (max(gaps) <= 1e-6 and k["launches"] == per
              and k["box_eval_launches"] == per
              and p["launches"] == p["box_eval_launches"] == zero
              and k["box_metrics"] == k["ap"]["box_metrics"]
              and k["box_metrics"]["total_gt_instances"] == n_gt
              and all(0.0 <= k["ap"][t][m] <= 1.0
                      for t in ("segm", "bbox")
                      for m in ("AP", "AP50", "AP75")))
        log(f"[eval {label}] kernel vs plain max gap {max(gaps):.3g} (tol "
            f"1e-6); launches {k['launches']} per split, expected {per}; "
            f"{k['tiles_per_s']:.2f} tiles/s, host AP share "
            f"{k['host_ap_share']:.3f}, parts (s) "
            f"{json.dumps(k['parts_s'])}")
        if not ok:
            raise AssertionError(f"eval {label}: kernel {k}, plain {p}")
        out[label] = dict(kernel=k, plain=p, launches_per_batch={
            n: v / nb for n, v in k["launches"].items()})
    return out


# ---------------------------------------------------------------------------
# The trainer CLIs (phases 15-16).
# ---------------------------------------------------------------------------
# The JAX package's quality commands: the flagship custom recipe
# (scripts/quality_matrix.py:83-90 with --coco_ap) and the two-stage
# from-scratch transfer run (STATUS.md "Round 3").
CUSTOM_B, TRANSFER_B = 16, 4
CUSTOM_CLI = ["--batch_size", str(CUSTOM_B), "--lr", "0.001",
              "--num_epochs", "10", "--lr_step_size", "6", "--fixed_heads",
              "--decode_proposals", "--mask_samples", "64", "--coco_ap",
              "--device_data", "on"]
TRANSFER_CLI = ["--batch_size", str(TRANSFER_B), "--stage1_epochs", "2",
                "--stage2_epochs", "8", "--clip_grad_norm", "10",
                "--coco_ap", "--device_data", "on"]
# A model that has not learned scores about 0 (PERF.md §4); the JAX
# package reached 0.901 and 0.976 on these runs.
MIN_TEST_MASK_AP50 = 0.5


def sparse_tiles(split: str) -> int:
    return dict(SPARSE_FRAMES)[split] * 25


def counted(fn, counters: dict, into: dict):
    """`fn`, adding to `into` the launches of `counters` each call makes."""
    def wrapped(*args, **kw):
        before = {k: c.launches for k, c in counters.items()}
        out = fn(*args, **kw)
        for k, c in counters.items():
            into[k] = into.get(k, 0) + c.launches - before[k]
        return out
    return wrapped


@contextlib.contextmanager
def patched(module, fns: dict):
    """The module's names in `fns` bound to the given objects inside the
    block, restored after it."""
    saved = {k: getattr(module, k) for k in fns}
    try:
        for k, fn in fns.items():
            setattr(module, k, fn)
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


class Recorder:
    """Stands in for a kernel's wrapper under its name in the module that
    calls it: passes every call on, and keeps copies of the arguments of
    the first `keep` calls made while `scope` is set. `launches` is the
    wrapper's own counter, which the wrapper raises through that name."""

    def __init__(self, fn, keep: int):
        self.fn, self.keep, self.scope, self.calls = fn, keep, None, {}

    def __call__(self, *args):
        if self.scope is not None:
            seen = self.calls.setdefault(self.scope, [])
            if len(seen) < self.keep:
                seen.append(tuple(a.detach().clone() if torch.is_tensor(a)
                                  else a for a in args))
        return self.fn(*args)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def scoped(fn, recorders, scope: str):
    """`fn`, with every recorder's scope set to `scope` while it runs."""
    def wrapped(*args, **kw):
        for r in recorders:
            r.scope = scope
        try:
            return fn(*args, **kw)
        finally:
            for r in recorders:
                r.scope = None
    return wrapped


def run_cli(module, argv: list, root, wraps: dict, counters: dict):
    """module.main(argv) from `root` (where it writes models/ and
    outputs/), the module's functions named in `wraps` replaced by their
    wrappers while it runs; returns (its result, the launches of
    `counters` over the whole run, counted from 0)."""
    import os
    cwd = os.getcwd()
    for c in counters.values():
        c.launches = 0
    os.chdir(root)
    try:
        with patched(module, wraps):
            out = module.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    return out, {k: c.launches for k, c in counters.items()}


def cli_kernel_cases(cra, cm, rec: dict, label: str = "custom CLI"
                     ) -> list:
    """K1-K4 against their plain versions on the inputs the custom CLI
    gave them (`rec`: the recorders of phase_custom_cli or of the resumed
    run of phase_jax_ckpt): K1/K2, K3 and K4 (full and max-only) on the
    first training step's, K1/K2 on both RoIAlign passes of the first
    test batch (proposals, then the refined detections) where the run
    kept one."""
    cases = []
    passes = [("train", 0)] + [("test", i) for i in range(
        len(rec["roi_weights"].calls.get("test", [])))]
    for scope, i in passes:
        boxes, _, out, ratio, scale, _ = rec["roi_weights"].calls[scope][i]
        feat = rec["roi_align_fwd"].calls[scope][i][0]
        cases += k12_cases(cra, feat, boxes, out, ratio, scale,
                           f"{label} {scope} pass {i + 1}")
    g, wy, wx, hw = rec["roi_align_bwd"].calls["train"][0]
    cases.append(k3_check(cra, g, wy, wx, hw, f"{label} train"))
    anchors, gt, valid, _ = rec["match_anchors"].calls["train"][0]
    b, slots = valid.shape
    for full in (True, False):
        cases.append(k4_case(cm, anchors, gt, valid, full,
                             f"{label} train B={b} I={slots}"))
    for c in cases:
        log("[kernels]", json.dumps(c))
    return cases


def check_served(label: str, engine, image, counters: dict, want: dict):
    """One request through `engine` with the counters zeroed just before
    it: the launches must be `want`, the output well formed."""
    for c in counters.values():
        c.launches = 0
    boxes, scores, masks = engine.predict(image, score_threshold=0.0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    h, w = image.shape[:2]
    res = dict(request=label, detections=len(boxes), launches=launches)
    log("[cli serve]", json.dumps(res))
    if not (launches == want and np.isfinite(boxes).all()
            and np.isfinite(scores).all()
            and masks.shape == (len(boxes), h, w)):
        raise AssertionError(f"{label}: {res}, expected launches {want}")
    return res


def phase_custom_cli(root, frame: np.ndarray) -> dict:
    """15. train_custom.main with the flagship quality command on a
    "sparse" split (350/75/75 tiles), full-width ModelConfig(), bf16
    compute: K1-K4 once per training step, K1/K2 once per RoIAlign pass
    of each eval batch (two with decode_proposals), finite losses, a
    checkpoint of epoch 10 that InferenceEngine serves, K1-K4 held
    against their plain versions on the inputs the run gave them
    (cli_kernel_cases), and test mask AP50 >= MIN_TEST_MASK_AP50."""
    from livecell_tpu_torch.models import mask_rcnn
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve.app import InferenceEngine
    from livecell_tpu_torch.train import train_custom

    t0 = time.perf_counter()
    draw_split(root, SEED + 15, "sparse", SPARSE_FRAMES)
    draw_s = time.perf_counter() - t0
    counters = train_counters()
    # Each kernel's inputs from the first training step and the first
    # test batch (two RoIAlign passes with decode_proposals).
    rec = {k: Recorder(fn, 1 if k in ("roi_align_bwd", "match_anchors")
                       else 2) for k, fn in counters.items()}
    recs = list(rec.values())
    train_l, test_l = {}, {}
    with patched(cra, {k: rec[k] for k in
                       ("roi_weights", "roi_align_fwd", "roi_align_bwd")}), \
            patched(mask_rcnn, {"match_anchors": rec["match_anchors"]}):
        out, total = run_cli(
            train_custom, ["--data_dir", str(root)] + CUSTOM_CLI, root,
            {"train_epoch": scoped(counted(
                train_custom.train_epoch, counters, train_l), recs, "train"),
             "evaluate_coco": scoped(counted(
                 train_custom.evaluate_coco, counters, test_l), recs,
                 "test")}, counters)
    model = out["model"]
    steps = out["steps_per_epoch"] * len(out["epoch_seconds"])
    per_fwd = 2 if model.cfg.decode_proposals else 1
    sweep = math.ceil(sparse_tiles("test") / CUSTOM_B)
    # Validation every epoch, the test box metrics, the test AP sweep.
    eval_batches = (len(out["epoch_seconds"]) + 2) * sweep
    want_total = {"roi_weights": steps + per_fwd * eval_batches,
                  "roi_align_fwd": steps + per_fwd * eval_batches,
                  "roi_align_bwd": steps, "match_anchors": steps}
    want_train = {k: steps for k in counters}
    want_test = {"roi_weights": per_fwd * sweep,
                 "roi_align_fwd": per_fwd * sweep, "roi_align_bwd": 0,
                 "match_anchors": 0}
    with open(Path(root) / out["model_path"] / "meta.json") as f:
        meta = json.load(f)
    ap = out["test_ap"]
    res = dict(draw_and_tile_s=draw_s, steps=steps,
               epoch_s=out["epoch_seconds"], img_per_s=out["img_per_s"],
               train_losses=out["train_losses"],
               val=out["val_metrics"][-1], test=out["test_metrics"],
               test_mask_ap=ap, launches=total, train_launches=train_l,
               test_sweep_launches=test_l, eval_batches=eval_batches,
               launches_per_step={k: v / steps for k, v in train_l.items()},
               launches_per_test_batch={k: v / sweep
                                        for k, v in test_l.items()})
    log("[custom cli]", json.dumps(res))
    log(f"[custom cli] epochs (s): "
        f"{', '.join(f'{x:.2f}' for x in out['epoch_seconds'])}; img/s: "
        f"{', '.join(f'{x:.1f}' for x in out['img_per_s'])}; test mask AP "
        f"{ap['AP']:.4f} AP50 {ap['AP50']:.4f} AP75 {ap['AP75']:.4f}")
    if not (total == want_total and train_l == want_train
            and test_l == want_test):
        raise AssertionError(
            f"custom cli: launches {total} (train {train_l}, test sweep "
            f"{test_l}), expected {want_total} ({want_train}, {want_test})")
    if not (np.isfinite(out["train_losses"]).all()
            and meta["epoch"] == len(out["epoch_seconds"])):
        raise AssertionError(f"custom cli: losses {out['train_losses']}, "
                             f"meta epoch {meta.get('epoch')}")
    out_path = out["model_path"]
    del out, model
    torch.cuda.empty_cache()
    res["cases"] = cli_kernel_cases(cra, cm, rec)
    del rec, recs
    engine = InferenceEngine(model_path=str(Path(root) / out_path))
    served = check_served("custom checkpoint, request (a)'s frame", engine,
                          frame, {k: counters[k] for k in
                                  ("roi_weights", "roi_align_fwd")},
                          {"roi_weights": per_fwd, "roi_align_fwd": per_fwd})
    res["served"] = served
    res["model_path"] = out_path
    if not ap["AP50"] >= MIN_TEST_MASK_AP50:
        raise AssertionError(f"custom cli: test mask AP50 {ap['AP50']:.4f} "
                             f"< {MIN_TEST_MASK_AP50}")
    return res


def transfer_cli_mfu(root, train_transfer) -> list:
    """The transfer CLI with --mfu and no epochs on the split in `root`,
    from a directory of its own (it saves a checkpoint): each stage
    prints its analytic step FLOPs and, on an H100, a numeric MFU."""
    import io

    buf = io.StringIO()
    (Path(root) / "mfu").mkdir()
    with contextlib.redirect_stdout(buf):
        run_cli(train_transfer, ["--data_dir", str(root), "--batch_size",
                                 str(TRANSFER_B), "--stage1_epochs", "0",
                                 "--stage2_epochs", "0", "--mfu"],
                Path(root) / "mfu", {}, {})
    lines = [ln.strip() for ln in buf.getvalue().splitlines()
             if "analytic step FLOPs" in ln or "MFU" in ln]
    log("[transfer cli --mfu]", json.dumps(lines))
    flops = [ln for ln in lines if ln.startswith("analytic step FLOPs")]
    mfu = [ln for ln in lines if "; MFU 0." in ln]
    if len(flops) != 2 or len(mfu) != 2:
        raise AssertionError(f"transfer cli --mfu printed {lines}")
    return lines


def phase_transfer_cli(root, frame: np.ndarray) -> dict:
    """16. train_transfer.main with the two-stage from-scratch command on
    a "sparse" split, full-width TransferConfig() from seed-0 weights:
    K4/K5/K6 1/2/2 per training step and K5 twice per eval batch; the
    backbone, FPN and RPN bit for bit unchanged over stage 1 and moved
    by stage 2; a checkpoint that names the transfer model and serves a
    frame and a 300x222 tile with K5 twice per forward; test mask AP50
    >= MIN_TEST_MASK_AP50."""
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.serve.app import InferenceEngine
    from livecell_tpu_torch.train import checkpoint, train_transfer

    t0 = time.perf_counter()
    draw_split(root, SEED + 16, "sparse", SPARSE_FRAMES)
    draw_s = time.perf_counter() - t0
    counters = {"match_anchors": cm.match_anchors,
                "ms_roi_align_fwd": cms.ms_roi_align_fwd,
                "ms_roi_align_bwd": cms.ms_roi_align_bwd}
    frozen = train_transfer.FROZEN_STAGE1
    snaps = []
    real_opt = train_transfer.stage_optimizer

    def stage_optimizer(model, *a, **kw):
        snaps.append({n: p.detach().clone()
                      for n, p in model.named_parameters()
                      if n.split(".")[0] in frozen})
        return real_opt(model, *a, **kw)

    train_l, test_l = {}, {}
    out, total = run_cli(
        train_transfer, ["--data_dir", str(root)] + TRANSFER_CLI, root,
        {"train_epoch": counted(train_transfer.train_epoch, counters,
                                train_l),
         "evaluate_coco_multi": counted(train_transfer.evaluate_coco_multi,
                                        counters, test_l),
         "stage_optimizer": stage_optimizer}, counters)
    model = out["model"]
    final = {n: p.detach() for n, p in model.named_parameters()
             if n.split(".")[0] in frozen}
    s1, s2 = snaps
    stage1_still = all(torch.equal(s1[n], s2[n]) for n in s1)
    stage2_moved = {m: sum(not torch.equal(s2[n], final[n]) for n in s2
                           if n.split(".")[0] == m) /
                    sum(n.split(".")[0] == m for n in s2) for m in frozen}
    del snaps, s1, s2, final
    n_epochs = sum(len(v) for v in out["stage_seconds"].values())
    steps = sparse_tiles("train") // TRANSFER_B * n_epochs
    sweep = math.ceil(sparse_tiles("test") / TRANSFER_B)
    eval_batches = (n_epochs + 2) * sweep
    want_train = {"match_anchors": steps, "ms_roi_align_fwd": 2 * steps,
                  "ms_roi_align_bwd": 2 * steps}
    want_total = dict(want_train, ms_roi_align_fwd=2 * steps
                      + 2 * eval_batches)
    want_test = {"match_anchors": 0, "ms_roi_align_fwd": 2 * sweep,
                 "ms_roi_align_bwd": 0}
    kind, _, _ = checkpoint.load_model_state(
        str(Path(root) / out["model_path"]))
    aps = out["test_ap"]
    res = dict(draw_and_tile_s=draw_s, steps=steps,
               stage_epoch_s=out["stage_seconds"],
               stage_img_per_s=out["stage_img_per_s"],
               val=out["history"][-1], test=out["test_metrics"],
               test_ap=aps, launches=total, train_launches=train_l,
               test_sweep_launches=test_l, eval_batches=eval_batches,
               launches_per_step={k: v / steps for k, v in train_l.items()},
               launches_per_test_batch={k: v / sweep
                                        for k, v in test_l.items()},
               stage1_frozen_unchanged=stage1_still,
               stage2_moved_share=stage2_moved, checkpoint_type=kind)
    log("[transfer cli]", json.dumps(res))
    for st, secs in out["stage_seconds"].items():
        log(f"[transfer cli] stage {st} epochs (s): "
            f"{', '.join(f'{x:.2f}' for x in secs)}; img/s: "
            f"{', '.join(f'{x:.1f}' for x in out['stage_img_per_s'][st])}")
    log(f"[transfer cli] test mask AP {aps['segm']['AP']:.4f} AP50 "
        f"{aps['segm']['AP50']:.4f} AP75 {aps['segm']['AP75']:.4f}; box AP "
        f"{aps['bbox']['AP']:.4f} AP50 {aps['bbox']['AP50']:.4f} AP75 "
        f"{aps['bbox']['AP75']:.4f}")
    if not (total == want_total and train_l == want_train
            and test_l == want_test):
        raise AssertionError(
            f"transfer cli: launches {total} (train {train_l}, test sweep "
            f"{test_l}), expected {want_total} ({want_train}, {want_test})")
    if not (stage1_still and min(stage2_moved.values()) > 0.5
            and kind == "transfer"):
        raise AssertionError(f"transfer cli: stage 1 frozen unchanged "
                             f"{stage1_still}, stage 2 moved "
                             f"{stage2_moved}, checkpoint type {kind}")
    res["mfu"] = transfer_cli_mfu(root, train_transfer)
    del out, model
    engine = InferenceEngine(model_path=str(
        Path(root) / "models" / "maskrcnn_resnet50_two_stage.ckpt"))
    k5 = {"ms_roi_align_fwd": cms.ms_roi_align_fwd}
    res["served"] = [
        check_served("transfer checkpoint, request (a)'s frame", engine,
                     frame, k5, {"ms_roi_align_fwd": 2}),
        check_served("transfer checkpoint, 300x222 tile", engine,
                     frame[:222, :300], k5, {"ms_roi_align_fwd": 2})]
    if not aps["segm"]["AP50"] >= MIN_TEST_MASK_AP50:
        raise AssertionError(f"transfer cli: test mask AP50 "
                             f"{aps['segm']['AP50']:.4f} < "
                             f"{MIN_TEST_MASK_AP50}")
    return res


# ---------------------------------------------------------------------------
# The serve front ends (phase 17).
# ---------------------------------------------------------------------------
# A test split of 15 "sparse" frames (375 tiles), the size of phase 13's.
FRONT_FRAMES = 15
MIN_FRAME_F1 = 0.5
# Explain main's picks on a 375-tile split: the first, middle and last
# tile (frame, tile number).
EXPLAIN_TILES = ((0, 0), (7, 12), (14, 24))


def frame_f1(results: list, annotations: list) -> dict:
    """Box metrics (train/metrics.py) of stitched frame detections against
    each frame's GT boxes, matched at IoU 0.5."""
    from livecell_tpu_torch.models.detector import Detections
    from livecell_tpu_torch.train.metrics import (
        MetricAccumulator, batch_eval_stats)
    acc = MetricAccumulator()
    for dets, anns in zip(results, annotations):
        n = len(dets.scores)
        gt = np.asarray([[a["bbox"][0], a["bbox"][1],
                          a["bbox"][0] + a["bbox"][2],
                          a["bbox"][1] + a["bbox"][3]] for a in anns],
                        np.float32)
        det = Detections(
            boxes=torch.from_numpy(dets.boxes.astype(np.float32))[None],
            scores=torch.from_numpy(dets.scores.astype(np.float32))[None],
            labels=torch.ones((1, n), dtype=torch.int32),
            valid=torch.ones((1, n), dtype=torch.bool),
            mask_probs=torch.zeros((1, n, 28, 28)))
        acc.update(batch_eval_stats(det, torch.from_numpy(gt)[None],
                                    torch.ones((1, len(gt)), dtype=bool),
                                    torch.ones(1, dtype=bool)))
    return acc.summary()


def explain_tiles(path: str, tiles: list, smi: str) -> dict:
    """The explainer's capture (serve/explain.py) on `tiles` with the
    trained custom checkpoint in f32, with roi_backend "kernel" and
    "plain": all twelve stages captured and finite, importance summing
    to 100; the ten stages before the heads equal (the RoIAlign route
    does not reach them), the heads within 1e-3 of their largest
    magnitude; K1/K2 launched once per RoIAlign pass of a tile on the
    kernel route."""
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve import explain
    from livecell_tpu_torch.serve.stitch import input_tile
    from livecell_tpu_torch.train import checkpoint

    _, cfg, sd = checkpoint.load_model_state(path)
    counters = {"roi_weights": cra.roi_weights,
                "roi_align_fwd": cra.roi_align_fwd}
    per_fwd = 2 if cfg.decode_proposals else 1
    ih, iw = input_tile(cfg)
    heads = ("box_head", "mask_head")
    res = []
    models = {}
    for route in ("kernel", "plain"):
        models[route] = create_model(dataclasses.replace(
            cfg, compute_dtype="float32", roi_backend=route))
        models[route].load_state_dict(sd)
    for k, tile in enumerate(tiles):
        canvas = np.zeros((ih, iw, 3), np.float32)
        canvas[:tile.shape[0], :tile.shape[1]] = tile / 255.0
        acts, launches = {}, {}
        for route, model in models.items():
            for c in counters.values():
                c.launches = 0
            det, acts[route] = explain.capture_activations(model, canvas)
            torch.cuda.synchronize()
            launches[route] = {n: c.launches for n, c in counters.items()}
        imp = explain.importance_percentages(acts["kernel"])
        props = explain.top_rpn_proposals(acts["kernel"], cfg)
        diffs = {n: float(np.abs(acts["kernel"][n] - acts["plain"][n]).max())
                 / max(float(np.abs(acts["plain"][n]).max()), 1e-30)
                 for n, _ in explain.STAGE_KEYS}
        equal = [n for n, _ in explain.STAGE_KEYS if n not in heads and
                 np.array_equal(acts["kernel"][n], acts["plain"][n])]
        r = dict(tile=k, stages=sorted(n for n, v in acts["kernel"].items()
                                       if v is not None),
                 importance_sum=sum(imp.values()),
                 relative_diff=diffs, equal_bit_for_bit=equal,
                 proposals=len(props), launches=launches,
                 detections=int((det.valid[0] & (det.scores[0] > 0.5))
                                .sum()))
        res.append(r)
        log(f"[explain] {smi} | {json.dumps(r)}")
        ok = (len(r["stages"]) == 12
              and all(np.isfinite(v).all() for v in acts["kernel"].values())
              and abs(r["importance_sum"] - 100.0) < 1e-3
              and all(diffs[n] <= 1e-6 for n, _ in explain.STAGE_KEYS
                      if n not in heads)
              and all(diffs[n] <= 1e-3 for n in heads)
              and launches["kernel"] == {n: per_fwd for n in counters}
              and launches["plain"] == {n: 0 for n in counters}
              and len(props) == 50)
        if not ok:
            raise AssertionError(f"explain tile {k}: {r}")
    if any(len(r["equal_bit_for_bit"]) < 10 for r in res):
        log("[explain] the stages before the heads differ between the two "
            "routes' models (within 1e-6): cuDNN varied between calls")
    del models
    torch.cuda.empty_cache()
    return dict(tiles=res, launches_per_tile={
        n: res[0]["launches"]["kernel"][n] for n in counters})


def phase_serve_fronts(root, ckpts: dict, smi: str) -> dict:
    """17. The visualize CLI's frame loop (serve/visualize.py:frame_stages
    through serve/pipeline.py:run_pipelined with fetch) over a 15-frame
    "sparse" test split with the checkpoints phases 15 and 16 trained
    (model 1 custom, model 2 transfer), its panels built with numpy only
    (GT and prediction overlays composited over the reconstructed
    frame, held as arrays; matplotlib is not on this machine): load_tiles
    and
    reconstruct_full_image equal to the drawn frames, pipelined
    detections equal to each predictor's serial run bit for bit, K1/K2
    once per custom RoIAlign pass and K5 twice per transfer frame, K1/K2
    and K5 against their plain versions on the first frame's inputs,
    stitched-frame box F1 >= MIN_FRAME_F1 for both models, a dispatch of
    each model free of synchronizing calls; the explainer on three tiles
    (explain_tiles)."""
    from livecell_tpu_torch.config import ModelConfig, TileConfig
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve import render, visualize
    from livecell_tpu_torch.serve.pipeline import run_pipelined
    from livecell_tpu_torch.serve.stitch import (
        group_tiles_by_image, make_frame_predictor, reconstruct_full_image)

    t0 = time.perf_counter()
    drawn = draw_split(root / "split", SEED + 17, "sparse",
                       (("test", FRONT_FRAMES),))["test"]
    draw_s = time.perf_counter() - t0
    tcfg = TileConfig()
    frame_hw = (tcfg.frame_height, tcfg.frame_width)
    groups = group_tiles_by_image(str(root / "split" / "test" / "images"))
    names = sorted(groups)
    frame_of = {n: i for i, n in enumerate(names)}
    if len(names) != FRONT_FRAMES:
        raise AssertionError(f"serve fronts: {len(names)} frames grouped")
    # The CLI's defaults: no dense flags.
    mcfg = ModelConfig()
    models = [visualize.load_model(ckpts["custom"], "custom", mcfg=mcfg),
              visualize.load_model(ckpts["transfer"], "transfer", mcfg=mcfg)]
    per_fwd = 2 if models[0].cfg.decode_proposals else 1
    preds = [make_frame_predictor(m, tcfg, 0.5, 0.4) for m in models]
    st = visualize.frame_stages(preds, ["custom", "transfer"], tcfg, {}, {})

    # Each kernel's inputs from the first frame: two RoIAlign passes each.
    counters = {"roi_weights": cra.roi_weights,
                "roi_align_fwd": cra.roi_align_fwd,
                "ms_roi_align_fwd": cms.ms_roi_align_fwd}
    rec = {k: Recorder(fn, 2) for k, fn in counters.items()}
    dispatch_ms = []

    def dispatch(decoded):
        if not dispatch_ms:
            for r in rec.values():
                r.scope = "frame"
        t = time.perf_counter()
        handles = st.dispatch(decoded)
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        for r in rec.values():
            r.scope = None
        return handles

    checks = {}

    def consume(item, decoded, results):
        name, _ = item
        tiles, _, _ = decoded
        i = frame_of[name]
        grey = drawn["frames"][i]
        want_tiles = frame_tiles(np.repeat(grey[..., None], 3, axis=2), tcfg)
        full = reconstruct_full_image(tiles, tcfg)
        ch = tcfg.mini_tile_height * tcfg.grid_size
        cw = tcfg.mini_tile_width * tcfg.grid_size
        base = (np.clip(full, 0, 1) * 255).astype(np.uint8)
        gt = visualize.decode_gt_masks(drawn["annotations"][i], frame_hw)
        panels = [render.composite(base, render.instance_overlay(
            gt, None, frame_hw))]
        panels += [render.composite(base, visualize.create_mask_overlay(
            d, frame_hw)) for d in results]
        checks[name] = dict(
            tiles_equal=bool(np.array_equal(tiles, want_tiles)),
            frame_equal=bool(np.array_equal(
                full[:ch, :cw],
                np.repeat(grey[:ch, :cw, None], 3, axis=2)
                .astype(np.float32) / 255.0)),
            gt_masks=len(gt), results=results,
            panels_ok=all(p.shape == frame_hw + (3,) for p in panels))

    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with patched(cra, {k: rec[k] for k in
                           ("roi_weights", "roi_align_fwd")}), \
                patched(cms, {"ms_roi_align_fwd": rec["ms_roi_align_fwd"]}):
            for c in counters.values():
                c.launches = 0
            stats = run_pipelined([(n, groups[n]) for n in names],
                                  st.decode, dispatch, consume,
                                  fetch_fn=st.fetch)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
        # Serial: each frame through each predictor's run(), timed.
        serial, same = [], []
        for n in names:
            tiles = st.decode((n, groups[n]))[0]
            for j, run in enumerate(preds):
                t = time.perf_counter()
                dets = run(tiles)
                serial.append((time.perf_counter() - t) * 1e3)
                same.append(all(np.array_equal(a, b) for a, b in zip(
                    dets, checks[n]["results"][j])))
    finally:
        torch.backends.cudnn.deterministic = old_det

    f1 = {label: frame_f1([checks[n]["results"][j] for n in names],
                          [drawn["annotations"][frame_of[n]] for n in names])
          for j, label in enumerate(("custom", "transfer"))}
    want = {"roi_weights": per_fwd * FRONT_FRAMES,
            "roi_align_fwd": per_fwd * FRONT_FRAMES,
            "ms_roi_align_fwd": 2 * FRONT_FRAMES}
    d = stats.as_dict()
    res = dict(draw_and_tile_s=draw_s, frames=stats.frames,
               errors=[repr(e) for _, e in stats.errors], stages=d,
               serial_frame_ms=sum(serial) / FRONT_FRAMES,
               dispatch_ms_median=statistics.median(dispatch_ms),
               launches=launches,
               launches_per_frame={k: v / FRONT_FRAMES
                                   for k, v in launches.items()},
               pipelined_equals_serial=all(same),
               tiles_equal=all(c["tiles_equal"] for c in checks.values()),
               frame_equal=all(c["frame_equal"] for c in checks.values()),
               panels_ok=all(c["panels_ok"] for c in checks.values()),
               gt_instances=sum(c["gt_masks"] for c in checks.values()),
               detections={label: sum(len(checks[n]["results"][j].scores)
                                      for n in names)
                           for j, label in enumerate(("custom", "transfer"))},
               box_f1=f1)
    log(f"[serve fronts] {smi} | {json.dumps(res)}")
    if not (stats.frames == FRONT_FRAMES and not stats.errors
            and res["tiles_equal"] and res["frame_equal"]
            and res["panels_ok"] and res["pipelined_equals_serial"]
            and launches == want):
        raise AssertionError(f"serve fronts: {res}, expected launches {want}")
    for label in ("custom", "transfer"):
        if not f1[label]["f1_score"] >= MIN_FRAME_F1:
            raise AssertionError(f"serve fronts: {label} frame box F1 "
                                 f"{f1[label]['f1_score']:.4f} < "
                                 f"{MIN_FRAME_F1}")

    # A frame's device time (profiler), and how long each model's
    # dispatch holds the host behind ~50 ms of device work already
    # queued (one spinning kernel, enqueued at once): with a pageable
    # copy (.to(), which waits for the queued work) against the
    # predictor's pinned, non-blocking one. Then no dispatch may make a
    # synchronizing call (torch.cuda.set_sync_debug_mode raises on one).
    tiles0 = st.decode((names[0], groups[names[0]]))[0]
    x0 = torch.from_numpy(tiles0).cuda()
    frame_prof = [profile_call(lambda: run.device_fn(x0)) for run in preds]
    cycles = 10 ** 7
    per_ms = cycles / time_ms(lambda: torch.cuda._sleep(cycles), warmup=1,
                              runs=3, calls=1)

    def queue():
        torch.cuda._sleep(int(50 * per_ms))

    copy = {"queued_ms": time_ms(queue, warmup=1, runs=3, calls=1)}
    for label, run in zip(("custom", "transfer"), preds):
        for kind, fn in (
                ("pageable", lambda: run.device_fn(
                    torch.from_numpy(tiles0).to("cuda"))),
                ("pinned", lambda: run.dispatch(tiles0))):
            for _ in range(3):
                torch.cuda.synchronize()
                queue()
                t = time.perf_counter()
                fn()
                copy.setdefault(f"{label}_{kind}_ms", []).append(
                    (time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = run.dispatch(tiles0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        run.fetch(handle)
    del x0
    res.update(frame_profile={"custom": frame_prof[0],
                              "transfer": frame_prof[1]},
               dispatch_behind_queued_work=copy)
    log(f"[serve fronts] {smi} | frame profiles {json.dumps(frame_prof)}")
    log(f"[serve fronts] {smi} | per frame: decode {d['decode_ms']} ms, "
        f"device {d['device_ms']} ms, overlay {d['overlay_ms']} ms; "
        f"pipelined {d['pipelined_fps']} frames/s against a serial sum of "
        f"{d['serial_sum_ms']} ms (predictors alone, serial: "
        f"{res['serial_frame_ms']:.2f} ms a frame); dispatch returns in "
        f"{res['dispatch_ms_median']:.2f} ms (both models), a frame's "
        f"device busy time {frame_prof[0]['device_busy_ms']:.2f} / "
        f"{frame_prof[1]['device_busy_ms']:.2f} ms (custom / transfer); "
        f"dispatch behind queued device work {json.dumps(copy)}; "
        f"launches per frame {json.dumps(res['launches_per_frame'])}; box "
        f"F1 {f1['custom']['f1_score']:.4f} / "
        f"{f1['transfer']['f1_score']:.4f} (custom / transfer)")
    del models, preds, st, checks
    torch.cuda.empty_cache()

    # K1/K2 and K5 against their plain versions on the first frame's
    # inputs (the proposals' pass, then the detections').
    cases = []
    for i, (boxes, _, out, ratio, scale, _) in enumerate(
            rec["roi_weights"].calls["frame"]):
        feat = rec["roi_align_fwd"].calls["frame"][i][0]
        cases += k12_cases(cra, feat, boxes, out, ratio, scale,
                           f"visualize custom frame pass {i + 1}")
    for feats, boxes, _, out_size, _ in rec["ms_roi_align_fwd"].calls["frame"]:
        cases += ms_roi_cases(cms, list(feats), boxes, out_size,
                              "visualize transfer frame", backward=False)
    for c in cases:
        log("[kernels]", json.dumps(c))
    del rec
    torch.cuda.empty_cache()

    # The explainer: the first, middle and last tile of the split.
    tiles = [frame_tiles(np.repeat(drawn["frames"][f][..., None], 3,
                                   axis=2), tcfg)[t]
             for f, t in EXPLAIN_TILES]
    res["explain"] = explain_tiles(ckpts["custom"], tiles, smi)
    res["cases"] = cases
    return res


# ---------------------------------------------------------------------------
# The mesh, the FLOP counter and the profiling helpers (phase 18).
# ---------------------------------------------------------------------------
# T2's geometry in f32 at batch 8 for the two-rank gloo step (4 a rank).
GLOO_BATCH, GLOO_STEPS = 8, 2
NCCL_STEPS = 3


def _stepper(model, pool, batch: int, mesh=None):
    """(step(i) -> the metrics of step i of `model` (SGD, lr 1e-3,
    momentum 0.9) on the first `batch` tiles of `pool` (this rank's rows
    with a mesh), its sampling noise from a generator seeded SEED + i;
    the optimizer)."""
    from livecell_tpu_torch.parallel.train_step import make_step_fn

    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    step = make_step_fn(model, opt, mesh)
    idx = torch.arange(batch, device=pool.images.device)
    if mesh is not None:
        idx = idx[mesh.rows(batch)]
    images, targets = pool.batch(idx)

    def run(i):
        m = step(images, targets,
                 generator=torch.Generator(device="cuda").manual_seed(
                     SEED + i))
        return {k: float(v) for k, v in m.items()}

    return run, opt


def _steps(model, pool, batch: int, steps: int, mesh=None):
    """The metrics of `steps` steps of _stepper's."""
    run, _ = _stepper(model, pool, batch, mesh)
    return [run(i) for i in range(steps)]


def _state_rel(got: dict, want: dict) -> float:
    """L2 distance of the parameter vectors over the L2 norm of `want`."""
    keys = [k for k, v in want.items() if v.is_floating_point()]
    diff = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
               for k in keys) ** 0.5
    norm = sum(float((want[k].double() ** 2).sum()) for k in keys) ** 0.5
    return diff / norm


def _metrics_rel(got: list, want: list) -> float:
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
               for g, w in zip(got, want) for k in w)


def phase_mesh_flops(cfg, tcfg, frame: np.ndarray, smi: str) -> dict:
    """(a) count_flops of the T1, T2 and T3 steps and of requests (a) and
    (d)'s device forwards at full width, on the kernel route and on the
    plain route (equal counts), each beside its time_fn median and its
    MFU against the H100's dense bf16 peak; one profiling.trace of a T1
    step, whose Chrome trace must name K1-K4's kernels."""
    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.mask_rcnn import (
        create_model, create_train_model)
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.parallel.train_step import (
        build_optimizer, make_step_fn)
    from livecell_tpu_torch.serve.stitch import make_frame_predictor
    from livecell_tpu_torch.train.train_transfer import stage_optimizer
    from livecell_tpu_torch.utils import profiling
    from livecell_tpu_torch.utils.flops import (
        _RULES, H100_BF16_PEAK, FlopCounter, count_flops, peak_flops)

    pool = make_pool(cfg, TRAIN_B, "cuda", SEED)
    images, targets = pool.batch(torch.arange(TRAIN_B, device="cuda"))
    tpool = transfer_pool(TransferConfig(), "cuda")
    tiles = torch.from_numpy(frame_tiles(frame, tcfg)).cuda()

    def custom_step(kw, route):
        c = dataclasses.replace(cfg, **kw, roi_backend=route,
                                match_backend=route)
        model = create_train_model(c, torch.Generator().manual_seed(SEED),
                                   device="cuda")
        step = make_step_fn(model, build_optimizer(model, 1e-3, 1e-4, 1))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return lambda: step(images, targets, generator=gen)

    def transfer_step(route):
        c = TransferConfig(roi_backend=route, rpn_match_backend=route)
        model = create_transfer_model(
            c, torch.Generator().manual_seed(SEED), device="cuda", train=True)
        step = make_step_fn(model, stage_optimizer(model, 5e-3, 0.9, 0.0,
                                                   False, clip_norm=10.0))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = pool_batch(tpool, 0, T_BATCH)
        return lambda: step(*batch, generator=gen)

    def request(kind, route):
        if kind == "a":
            model = create_model(dataclasses.replace(
                cfg, roi_backend=route, match_backend=route),
                torch.Generator().manual_seed(SEED))
        else:
            model = create_transfer_model(
                TransferConfig(roi_backend=route, rpn_match_backend=route),
                torch.Generator().manual_seed(SEED))
        run = make_frame_predictor(model, tcfg, score_threshold=0.0)
        return lambda: run.device_fn(tiles)

    calls = {"T1": lambda r: custom_step(TRAIN_CFGS["T1"], r),
             "T2": lambda r: custom_step(TRAIN_CFGS["T2"], r),
             "T3": transfer_step,
             "a": lambda r: request("a", r),
             "d": lambda r: request("d", r)}
    peak = peak_flops("cuda")
    rows = {}
    aten = {p.__name__ for p in _RULES}
    for name, make in calls.items():
        fn = make("kernel")
        with FlopCounter() as counter:
            fn()
        flops = counter.total
        # The kernels' charges (JAX's Pallas bodies: dense over every ROI
        # and level) beside what the aten matmuls and convolutions did.
        charged = sum(v for k, v in counter.by_op.items() if k not in aten)
        plain = count_flops(make("plain"))
        median = profiling.time_fn(fn, warmup=2, iters=7)["median_s"]
        rows[name] = dict(tflop=flops / 1e12, plain_tflop=plain / 1e12,
                          kernel_charge_tflop=charged / 1e12,
                          median_ms=median * 1e3,
                          tflop_per_s=flops / median / 1e12,
                          mfu=None if peak is None else flops / median / peak,
                          mfu_without_kernel_charges=None if peak is None
                          else (flops - charged) / median / peak)
        log(f"[mesh flops] {smi} | {name}", json.dumps(rows[name]))
        if flops != plain or not flops > 0:
            raise AssertionError(f"flops {name}: kernel route {flops}, plain "
                                 f"route {plain}")
        torch.cuda.empty_cache()
    log(f"[mesh flops] {smi} | MFU against {H100_BF16_PEAK / 1e12:.1f} "
        f"TFLOP/s (H100 SXM5 dense bf16)" if peak is not None else
        f"[mesh flops] {smi} | not an H100 SXM: MFU unknown")

    # One traced T1 step: the Chrome trace names K1-K4. A profiler
    # session on this card now and then records only some launches, so
    # up to three sessions are tried.
    step = custom_step(TRAIN_CFGS["T1"], "kernel")
    step()
    names = ("roi_weights_kernel", "roi_align_fwd_kernel",
             "roi_align_bwd_kernel", "match_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(3):
            with profiling.trace(tmp) as prof:
                step()
            text = Path(prof.trace_path).read_text()
            found = {k: k in text for k in names}
            log(f"[mesh trace] attempt {attempt + 1}: {found}, "
                f"{len(text)} bytes")
            if all(found.values()):
                break
        else:
            raise AssertionError(f"trace of a T1 step misses kernels: {found}")
    log(f"[mesh memory] peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    del pool, tpool
    torch.cuda.empty_cache()
    return rows


def phase_mesh_nccl(cfg, tcfg, frame: np.ndarray) -> dict:
    """(b) World size 1 over NCCL in this process: NCCL_STEPS T2 steps at
    batch 32 through the mesh step equal the no-mesh step bit for bit
    (losses, gradient norm, every parameter and buffer), and request (a)
    through the mesh frame predictor equals the no-mesh predictor bit for
    bit."""
    import os

    import torch.distributed as dist

    from livecell_tpu_torch.models.mask_rcnn import (
        create_model, create_train_model)
    from livecell_tpu_torch.parallel.mesh import make_mesh
    from livecell_tpu_torch.serve.stitch import make_frame_predictor

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        t2 = dataclasses.replace(cfg, **TRAIN_CFGS["T2"])
        pool = make_pool(t2, TRAIN_B, "cuda", SEED)
        torch.backends.cudnn.deterministic = True
        runs = {}
        for label, m in (("no mesh", None), ("mesh", mesh)):
            model = create_train_model(
                t2, torch.Generator().manual_seed(SEED), device="cuda")
            runs[label] = (_steps(model, pool, TRAIN_B, NCCL_STEPS, m),
                           {k: v.clone() for k, v in
                            model.state_dict().items()})
            del model
        (m0, s0), (m1, s1) = runs["no mesh"], runs["mesh"]
        steps_equal = m0 == m1
        state_equal = all(torch.equal(s0[k], s1[k]) for k in s0)
        model = create_model(cfg, torch.Generator().manual_seed(SEED))
        tiles = frame_tiles(frame, tcfg)
        dets = [make_frame_predictor(model, tcfg, score_threshold=0.0,
                                     mesh=m)(tiles) for m in (None, mesh)]
        predict_equal = all(
            np.array_equal(a, b) for a, b in zip(dets[0], dets[1]))
        torch.backends.cudnn.deterministic = False
        res = dict(world=1, backend=dist.get_backend(), mesh=repr(mesh),
                   steps=NCCL_STEPS, batch=TRAIN_B, steps_equal=steps_equal,
                   state_equal=state_equal, predict_equal=predict_equal,
                   detections=len(dets[0].scores),
                   total_loss=[x["total_loss"] for x in m1],
                   grad_norm=[x["grad_norm"] for x in m1])
        log("[mesh nccl]", json.dumps(res))
        if not (steps_equal and state_equal and predict_equal):
            raise AssertionError(f"mesh at world size 1 differs: {res}")
    finally:
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK"):
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gloo_rank(rank: int, port: int, out_dir: str) -> None:
    """One of two ranks on the card over gloo (phase 18 (c)): GLOO_STEPS
    f32 T2-geometry steps of the mesh step on its rows of the batch, the
    kernel routes, batch norm in train mode, the full state and
    optimizer state after each; then which gloo collectives take CUDA
    tensors. Rank 0 writes the results."""
    from datetime import timedelta

    import torch.distributed as dist

    from livecell_tpu_torch.config import ModelConfig
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.parallel.mesh import full_state, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN picks a convolution's algorithm by its batch size, so a rank's
    # 4 images and the single process's 8 round differently and a
    # proposal top-k can flip; PyTorch's own convolution (one GEMM an
    # image) gives each image the same bits at any batch size.
    torch.backends.cudnn.enabled = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh(device="cuda:0")
        cfg = gloo_cfg(ModelConfig())
        pool = make_pool(cfg, GLOO_BATCH, "cuda", SEED)
        model = create_train_model(cfg, torch.Generator().manual_seed(SEED),
                                   device="cuda")
        run, opt = _stepper(model, pool, GLOO_BATCH, mesh)
        metrics, states = [], []
        for i in range(GLOO_STEPS):
            metrics.append(run(i))
            sd, osd = full_state(model, mesh, opt)
            # Copies: both dicts hold the live tensors the next step
            # updates in place.
            states.append(({k: v.cpu() for k, v in sd.items()},
                           copy.deepcopy(osd)))
        # Which collectives gloo runs on CUDA tensors (the mesh needs
        # all_reduce only). Every rank takes the same branch, so a
        # refusal is local and both ranks go on.
        x = torch.full((4,), float(rank + 1), device="cuda")
        probes = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "broadcast": lambda: dist.broadcast(x.clone(), 0),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8, device="cuda"), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(2, device="cuda"), x),
        }
        accepted = {}
        for name, fn in probes.items():
            try:
                fn()
                torch.cuda.synchronize()
                accepted[name] = True
            except (RuntimeError, ValueError) as e:
                accepted[name] = f"{type(e).__name__}: {str(e)[:120]}"
        if rank == 0:
            torch.save({"metrics": metrics, "states": states,
                        "accepted": accepted}, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def gloo_cfg(cfg):
    """T2's geometry in f32 with the kernel routes."""
    return dataclasses.replace(cfg, **TRAIN_CFGS["T2"],
                               compute_dtype="float32", roi_backend="kernel",
                               match_backend="kernel")


def phase_mesh_gloo(cfg) -> dict:
    """(c) Two ranks on the one card over gloo, data = 2, in spawned
    processes: GLOO_STEPS f32 T2-geometry steps at batch GLOO_BATCH with
    the kernel routes and train-mode batch norm against the single
    process on the same card, 1e-5 relative on the losses and gradient
    norm of each step and on the parameter vector (L2) after it. Both
    sides run PyTorch's own convolutions (cuDNN off; see gloo_rank).

    Each step is compared from the same state: the single process takes
    step i + 1 from the state and momentum the mesh had after step i
    (gathered), so a second step compares the mesh's arithmetic and its
    carried state, not the chaos of this random-weight model, whose
    proposal ranking flips on the last bit of a parameter (on an NVIDIA
    H100 80GB HBM3 at 700 W, a second step from each side's own first
    update moved the gradient norm by 1.2e-5 to 6.9e-5 while every
    first-step metric agreed within 1e-7; PERF.md §6)."""
    import torch.multiprocessing as mp

    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.models.resnet import BatchNorm
    from livecell_tpu_torch.parallel.mesh import DataAxis

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(gloo_rank, args=(free_port(), tmp), nprocs=2,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t0
        got = torch.load(Path(tmp) / "rank0.pt", weights_only=False)
    torch.backends.cudnn.enabled = False      # as in gloo_rank
    c = gloo_cfg(cfg)
    pool = make_pool(c, GLOO_BATCH, "cuda", SEED)
    model = create_train_model(c, torch.Generator().manual_seed(SEED),
                               device="cuda")
    # The mesh's batch norm (f64-sum statistics) on one process, where
    # the card's single-process path takes cuDNN's: the two sides then
    # differ only by the split of the batch.
    one = DataAxis(None, 1, 0)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_axis = one
    run, opt = _stepper(model, pool, GLOO_BATCH)
    want, params_err = [], []
    for i, (sd, osd) in enumerate(got["states"]):
        want.append(run(i))
        params_err.append(_state_rel(
            sd, {k: v.cpu() for k, v in model.state_dict().items()}))
        model.load_state_dict(sd)
        opt.load_state_dict(osd)
    torch.backends.cudnn.enabled = True
    res = dict(world=2, backend="gloo", batch=GLOO_BATCH, steps=GLOO_STEPS,
               spawn_and_steps_s=spawn_s,
               metrics_rel_err=_metrics_rel(got["metrics"], want),
               params_rel_err=max(params_err),
               params_rel_err_per_step=params_err,
               gloo_cuda_collectives=got["accepted"],
               losses_mesh=got["metrics"], losses_single=want)
    log("[mesh gloo]", json.dumps(res))
    if not (res["metrics_rel_err"] <= 1e-5 and res["params_rel_err"] <= 1e-5
            and got["accepted"]["all_reduce"] is True):
        raise AssertionError(f"two-rank gloo step differs: {res}")
    del model, pool
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# The quality tools (phase 19).
# ---------------------------------------------------------------------------
# A dense split (500 cells a frame, ~111 instances a tile) of 4/1/1
# frames: the tiler's 70/15/15 selection of 6 frames keeps 4/0/1 of
# them, 100 training tiles and 25 test tiles, and no validation split.
DENSE_FRAMES = (4, 1, 1)
GT_CAPS = {"reference": ["--dets", "50", "--det_nms", "0.5"],
           "lifted": ["--dets", "256", "--det_nms", "0.6"]}
EVAL_LIFTED = ["--dets", "256", "--infer_nms", "0.7", "--det_nms", "0.6"]
ORACLE_TILES, ORACLE_B = 16, 8
A4X_SIZES = (8, 16, 32, 64)
# The transfer CLI's --track_preds on two ranks: one step of batch 4.
TRACK_TILES = 4
TRACK_CLI = ["--batch_size", "4", "--stage1_epochs", "1", "--stage2_epochs",
             "0", "--clip_grad_norm", "10", "--device_data", "off",
             "--track_preds"]


def track_cfg():
    """The transfer model of phase 19 (g): TransferConfig() in f32."""
    from livecell_tpu_torch.config import TransferConfig
    return dataclasses.replace(TransferConfig(), compute_dtype="float32")


def track_preds_rank(rank: int, port: int, argv: list, cwd: str,
                     out_dir: str) -> None:
    """One of two ranks of the transfer CLI with --track_preds on the
    card (phase 19 (g)), under torchrun's environment with both ranks on
    device 0 over gloo (NCCL refuses two ranks a device; the trainer
    takes the process group made here), f32 and PyTorch's own
    convolutions as in gloo_rank; writes what the rank printed."""
    import contextlib
    import io
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from livecell_tpu_torch.train import train_transfer

    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    dist.init_process_group("gloo", timeout=timedelta(seconds=300))
    try:
        os.chdir(cwd)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_transfer.main(argv, transfer_cfg=track_cfg())
        (Path(out_dir) / f"rank{rank}.txt").write_text(buf.getvalue())
    finally:
        dist.destroy_process_group()


def trim_split(split: Path, n: int) -> None:
    """Keep the first `n` tiles of each annotation file under `split`."""
    for path in (split / "annotations").glob("*.json"):
        d = json.loads(path.read_text())
        keep = {im["id"] for im in d["images"][:n]}
        d["images"] = [im for im in d["images"] if im["id"] in keep]
        d["annotations"] = [a for a in d["annotations"]
                            if a["image_id"] in keep]
        path.write_text(json.dumps(d))


def recorded_k12_cases(cra, rec: dict, scope: str, label: str) -> list:
    """K1/K2 against their plain versions on every RoIAlign pass the
    recorders kept under `scope`."""
    cases = []
    for i, (boxes, _, out, ratio, scale, _) in enumerate(
            rec["roi_weights"].calls[scope]):
        feat = rec["roi_align_fwd"].calls[scope][i][0]
        cases += k12_cases(cra, feat, boxes, out, ratio, scale,
                           f"{label} pass {i + 1}")
    for c in cases:
        log("[kernels]", json.dumps(c))
    return cases


def phase_quality_tools(root: Path, ckpt: str, sparse: str, cli: dict
                        ) -> dict:
    """19. The quality tools (livecell_tpu_torch/tools/) at full width
    (phase 15's checkpoint: ModelConfig(), bf16) under `root`: (a) a
    dense split, its auto slot count above 128; (b) gt_bound's ceilings
    at reference and lifted caps; (c) eval_ckpt on phase 15's checkpoint
    and split (`sparse`): the reference-caps row equal to phase 15's test
    mask AP/AP50/AP75 and box F1 within 1e-4, the lifted-caps row and
    the dense split's, K1/K2 twice per eval batch; (d) K1/K2 against
    their plain versions on the inputs eval_ckpt gave them at lifted
    caps (16 x 256); (e) oracle_probe on 16 dense tiles: arm A's mean
    IoU >= 0.95, arms B and C finite, K1/K2 three times per batch, and
    K1/K2 against their plain versions on arm B's GT boxes (K = the
    split's slot count); (f) quality_matrix through its subprocess path
    on the dense split for one epoch: the child trainer's slot count
    above 128 (K4 in fixed mode over two or more 128-slot GT tiles),
    both rows parsed; K4 full and max-only, exact against its plain
    version, on the first training batch's GT at 38,304 anchors and at
    the a4x recipe's 51,072; (g) the transfer CLI with --track_preds on
    two gloo ranks on the card against one process: the printed counts
    equal."""
    import contextlib
    import io
    import os

    import torch.multiprocessing as mp

    from livecell_tpu_torch.config import ModelConfig
    from livecell_tpu_torch.data.dataset import get_datasets, instance_slots
    from livecell_tpu_torch.data.device_data import epoch_indices
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.ops.anchors import generate_anchors
    from livecell_tpu_torch.tools import (
        eval_ckpt, gt_bound, oracle_probe, quality_matrix, synth_splits)
    from livecell_tpu_torch.train import train_transfer

    secs, res, cases = {}, {}, []
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # (a) The dense split and its slot count.
    dense_root = root / "dense"
    synth_splits.build("dense", dense_root, DENSE_FRAMES, SEED)
    dense = str(dense_root / "split")
    dsets = get_datasets(dense, ModelConfig(), device="cuda")
    counts = np.concatenate([d.instance_counts() for d in dsets.values()])
    slots = instance_slots(int(counts.max()))
    res["dense_split"] = dict(
        tiles={k: len(d) for k, d in dsets.items()},
        instances_per_tile_mean=float(counts.mean()),
        instances_per_tile_max=int(counts.max()), slots=slots)
    log("[quality] dense split", json.dumps(res["dense_split"]))
    if not slots > 128:
        raise AssertionError(f"dense split slots {slots}, expected > 128")
    part("a_split")

    # (b) The model-free ceilings.
    res["gt_bound"] = {caps: gt_bound.main(["--data_dir", dense] + argv)
                       for caps, argv in GT_CAPS.items()}
    for caps, r in res["gt_bound"].items():
        log(f"[quality] gt_bound dense {caps} ({r['dets']} dets, NMS "
            f"{r['det_nms']}): segm AP {r['segm_AP']} bbox AP "
            f"{r['bbox_AP']} over {r['n_gt_total']} GT in {r['n_tiles']} "
            f"tiles")
        if not 0 < r["segm_AP"] <= 1:
            raise AssertionError(f"gt_bound {caps}: {r}")
    part("b_gt_bound")

    # (c), (d) eval_ckpt on phase 15's checkpoint: its own split at the
    # reference caps (phase 15's numbers), lifted caps (K1/K2's inputs
    # recorded), and the dense split.
    counters = {"roi_weights": cra.roi_weights,
                "roi_align_fwd": cra.roi_align_fwd}
    rec = {k: Recorder(fn, 2) for k, fn in counters.items()}
    recs = list(rec.values())
    rows, eval_launches = {}, {}
    with patched(cra, rec):
        for label, data, caps in (("sparse reference", sparse, []),
                                  ("sparse lifted", sparse, EVAL_LIFTED),
                                  ("dense lifted", dense, EVAL_LIFTED)):
            fn = eval_ckpt.evaluate_coco_multi
            if label == "sparse lifted":
                fn = scoped(fn, recs, "eval")
            for c in counters.values():
                c.launches = 0
            with patched(eval_ckpt, {"evaluate_coco_multi": fn}):
                rows[label] = eval_ckpt.main(
                    ["--ckpt", ckpt, "--data_dir", data] + caps)
            torch.cuda.synchronize()
            tiles = len(dsets["test"]) if data == dense else \
                sparse_tiles("test")
            batches = math.ceil(tiles / 16)
            eval_launches[label] = {k: c.launches / batches
                                    for k, c in counters.items()}
            log(f"[quality] eval_ckpt {label}: {json.dumps(rows[label])}; "
                f"launches per batch {eval_launches[label]}")
    want = cli["test_mask_ap"]
    gaps = {"mask_AP": rows["sparse reference"]["mask_AP"] - want["AP"],
            "mask_AP50": rows["sparse reference"]["mask_AP50"]
            - want["AP50"],
            "mask_AP75": rows["sparse reference"]["mask_AP75"]
            - want["AP75"],
            "f1": rows["sparse reference"]["f1"] - cli["test"]["f1_score"]}
    log(f"[quality] eval_ckpt vs phase 15's test metrics: gaps "
        f"{json.dumps(gaps)} (tol 1e-4)")
    if not (all(abs(g) <= 1e-4 for g in gaps.values())
            and all(v == {"roi_weights": 2, "roi_align_fwd": 2}
                    for v in eval_launches.values())
            and rows["sparse lifted"]["dets"] == 256):
        raise AssertionError(f"eval_ckpt: gaps {gaps}, launches "
                             f"{eval_launches}")
    res.update(eval_rows=rows, eval_gaps=gaps,
               launches_per_eval_batch=eval_launches["sparse lifted"])
    part("c_eval_ckpt")
    cases += recorded_k12_cases(cra, rec, "eval", "eval_ckpt lifted caps")
    del rec, recs
    torch.cuda.empty_cache()
    part("d_eval_kernels")

    # (e) The oracle probe on the dense split.
    rec = {k: Recorder(fn, 1) for k, fn in counters.items()}
    for c in counters.values():
        c.launches = 0
    with patched(cra, rec), patched(oracle_probe, {
            "oracle_mask_probs": scoped(oracle_probe.oracle_mask_probs,
                                        list(rec.values()), "oracle")}):
        report = oracle_probe.main(
            ["--ckpt", ckpt, "--data_dir", dense, "--batch_size",
             str(ORACLE_B), "--max_images", str(ORACLE_TILES), "--out",
             str(root / "oracle.json")])
    torch.cuda.synchronize()
    batches = math.ceil(report["images"] / ORACLE_B)
    oracle_launches = {k: c.launches / batches for k, c in counters.items()}
    means = {arm: report[arm]["mean"] for arm in oracle_probe.ARMS}
    log(f"[quality] oracle_probe {report['images']} dense tiles: means "
        f"{json.dumps(means)}; frac>=0.75 "
        f"{json.dumps({a: report[a]['frac_ge_75'] for a in means})}; "
        f"launches per batch {oracle_launches}")
    if not (report["images"] == ORACLE_TILES
            and means["quant_ceiling"] >= 0.95
            and all(math.isfinite(v) for v in means.values())
            and oracle_launches == {"roi_weights": 3, "roi_align_fwd": 3}):
        raise AssertionError(f"oracle_probe: {means}, {oracle_launches}")
    res.update(oracle=report, launches_per_oracle_batch=oracle_launches)
    cases += recorded_k12_cases(cra, rec, "oracle", "oracle arm B")
    del rec
    torch.cuda.empty_cache()
    part("e_oracle")

    # (f) The quality matrix through its subprocess path.
    children = []

    def runner(cmd, **kw):
        r = subprocess.run(cmd, **kw)
        children.append((cmd, r))
        return r

    matrix = quality_matrix.main(
        ["--splits", f"dense:{dense_root}", "--epochs", "1", "--out",
         str(root / "matrix.jsonl")], runner=runner)
    train_out = children[0][1].stdout
    line = next((ln for ln in train_out.splitlines()
                 if "Instance slots:" in ln), "")
    child_slots = int(line.split("->")[1].split()[0]) if line else 0
    log(f"[quality] quality_matrix child trainer: {line.strip()}")
    for r in matrix:
        log(f"[quality] quality_matrix {r['split']}/{r['caps']}: "
            f"{json.dumps(r)}")
    if not (child_slots == slots > 128 and len(matrix) == 2
            and all(math.isfinite(r["mask_AP"]) for r in matrix)):
        raise AssertionError(f"quality_matrix: slots {child_slots}, rows "
                             f"{matrix}")
    res.update(matrix=matrix, matrix_child_slots=child_slots)
    part("f_matrix")
    # K4 on the child's first training batch (seed 0, epoch 1: the
    # index matrix of seed 1) at the flagship's anchors and at a4x's.
    train = dsets["train"]
    train.cfg = dataclasses.replace(ModelConfig(), max_instances=slots)
    _, targets = train.gather(epoch_indices(len(train), CUSTOM_B, True,
                                            SEED + 1)[0])
    gt = torch.from_numpy(targets["boxes"]).cuda()
    valid = torch.from_numpy(targets["valid"]).cuda()
    cfg = ModelConfig()
    for label, sizes in (("flagship", cfg.anchor_sizes),
                         ("a4x", A4X_SIZES)):
        anchors = torch.from_numpy(generate_anchors(
            (cfg.feature_height, cfg.feature_width), cfg.anchor_stride,
            sizes, cfg.anchor_ratios)).cuda()
        for full in (True, False):
            cases.append(k4_case(cm, anchors, gt, valid, full,
                                 f"dense {label} B={CUSTOM_B} I={slots} "
                                 f"A={len(anchors)}"))
            log("[kernels]", json.dumps(cases[-1]))
    del gt, valid, anchors
    torch.cuda.empty_cache()
    part("f_k4")

    # (g) --track_preds on two gloo ranks against one process.
    track = root / "track"
    synth_splits.build("sparse", track, (1, 1, 1), SEED)
    trim_split(track / "split", TRACK_TILES)
    argv = ["--data_dir", str(track / "split")] + TRACK_CLI
    for d in ("mesh", "single"):
        (track / d).mkdir()
    mp.start_processes(track_preds_rank, args=(
        free_port(), argv, str(track / "mesh"), str(track)), nprocs=2,
        start_method="spawn")
    printed = [(track / f"rank{r}.txt").read_text() for r in range(2)]
    cwd = os.getcwd()
    buf = io.StringIO()
    torch.backends.cudnn.enabled = False      # as in track_preds_rank
    try:
        os.chdir(track / "single")
        with contextlib.redirect_stdout(buf):
            train_transfer.main(argv, transfer_cfg=track_cfg())
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.enabled = True

    def counts(text):
        return [ln.strip() for ln in text.splitlines() if "preds>0.5" in ln]

    res["track_preds"] = dict(mesh=counts(printed[0]),
                              rank1=counts(printed[1]),
                              single=counts(buf.getvalue()))
    log(f"[quality] --track_preds: {json.dumps(res['track_preds'])}")
    if not (len(res["track_preds"]["mesh"]) == 1
            and res["track_preds"]["mesh"] == res["track_preds"]["single"]
            and not res["track_preds"]["rank1"]):
        raise AssertionError(f"--track_preds on two ranks: "
                             f"{res['track_preds']}")
    torch.cuda.empty_cache()
    part("g_track_preds")

    res.update(parts_s=secs, cases=cases)
    log(f"[quality] parts (s) {json.dumps(secs)}")
    return res


# ---------------------------------------------------------------------------
# The measurement tools (phase 20).
# ---------------------------------------------------------------------------
# Fewer timed steps than the tools' defaults where those would cost
# minutes; every tool at its JAX defaults' widths otherwise.
MEASURE_STEPS = {"profile_step": 10, "profile_transfer": 6, "roofline": 10,
                 "bench_transfer_nms": 10}
BUSY_AGREEMENT = 0.10        # trace_summary's busy time vs profile_call's


def fake_torchvision_state_dict(seed: int = SEED, num_classes: int = 91
                                ) -> dict:
    """A torchvision maskrcnn_resnet50_fpn state dict with every key at
    its shape, drawn from a seed with numpy (tests/util_torchvision_fake
    .py's layout and draws, copied: the port does not import the
    tests)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(name, *shape):
        sd[name] = rng.normal(0, 0.02, size=shape).astype(np.float32)

    def bn(prefix, ch):
        t(f"{prefix}.weight", ch)
        t(f"{prefix}.bias", ch)
        t(f"{prefix}.running_mean", ch)
        sd[f"{prefix}.running_var"] = np.abs(
            rng.normal(1, 0.1, size=ch)).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(1, np.int64)

    body = "backbone.body"
    t(f"{body}.conv1.weight", 64, 3, 7, 7)
    bn(f"{body}.bn1", 64)
    in_ch = 64
    for stage, (depth, w) in enumerate(zip((3, 4, 6, 3),
                                           (64, 128, 256, 512)), 1):
        for j in range(depth):
            p = f"{body}.layer{stage}.{j}"
            t(f"{p}.conv1.weight", w, in_ch, 1, 1)
            bn(f"{p}.bn1", w)
            t(f"{p}.conv2.weight", w, w, 3, 3)
            bn(f"{p}.bn2", w)
            t(f"{p}.conv3.weight", w * 4, w, 1, 1)
            bn(f"{p}.bn3", w * 4)
            if j == 0:
                t(f"{p}.downsample.0.weight", w * 4, in_ch, 1, 1)
                bn(f"{p}.downsample.1", w * 4)
            in_ch = w * 4
    for i, c in enumerate((256, 512, 1024, 2048)):
        t(f"backbone.fpn.inner_blocks.{i}.0.weight", 256, c, 1, 1)
        t(f"backbone.fpn.inner_blocks.{i}.0.bias", 256)
        t(f"backbone.fpn.layer_blocks.{i}.0.weight", 256, 256, 3, 3)
        t(f"backbone.fpn.layer_blocks.{i}.0.bias", 256)
    t("rpn.head.conv.0.0.weight", 256, 256, 3, 3)
    t("rpn.head.conv.0.0.bias", 256)
    t("rpn.head.cls_logits.weight", 3, 256, 1, 1)
    t("rpn.head.cls_logits.bias", 3)
    t("rpn.head.bbox_pred.weight", 12, 256, 1, 1)
    t("rpn.head.bbox_pred.bias", 12)
    t("roi_heads.box_head.fc6.weight", 1024, 256 * 7 * 7)
    t("roi_heads.box_head.fc6.bias", 1024)
    t("roi_heads.box_head.fc7.weight", 1024, 1024)
    t("roi_heads.box_head.fc7.bias", 1024)
    t("roi_heads.box_predictor.cls_score.weight", num_classes, 1024)
    t("roi_heads.box_predictor.cls_score.bias", num_classes)
    t("roi_heads.box_predictor.bbox_pred.weight", num_classes * 4, 1024)
    t("roi_heads.box_predictor.bbox_pred.bias", num_classes * 4)
    for k in range(1, 5):
        t(f"roi_heads.mask_head.mask_fcn{k}.weight", 256, 256, 3, 3)
        t(f"roi_heads.mask_head.mask_fcn{k}.bias", 256)
    t("roi_heads.mask_predictor.conv5_mask.weight", 256, 256, 2, 2)
    t("roi_heads.mask_predictor.conv5_mask.bias", 256)
    t("roi_heads.mask_predictor.mask_fcn_logits.weight",
      num_classes, 256, 1, 1)
    t("roi_heads.mask_predictor.mask_fcn_logits.bias", num_classes)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def run_tool(mod, argv: list):
    """A tool's main on the card, its standard output passed through and
    parsed: (the returned value, the printed JSON lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return ret, [json.loads(ln) for ln in text.splitlines()
                 if ln.startswith("{")]


def positive(name: str, rec: dict, keys) -> None:
    bad = {k: rec.get(k) for k in keys
           if not (isinstance(rec.get(k), (int, float))
                   and math.isfinite(rec[k]) and rec[k] > 0)}
    if bad:
        raise AssertionError(f"{name}: times not finite and > 0: {bad}")


def zeroed(counters: dict) -> dict:
    for fn in counters.values():
        fn.launches = 0
    return counters


def tallied(fn, counters: dict, tally: dict, key):
    """`fn`, adding to tally[key(*args)] one call and the launches of
    `counters` that call makes."""
    def wrapped(*args, **kw):
        before = {k: c.launches for k, c in counters.items()}
        out = fn(*args, **kw)
        row = tally.setdefault(key(*args, **kw),
                               dict.fromkeys(("calls", *counters), 0))
        row["calls"] += 1
        for k, c in counters.items():
            row[k] += c.launches - before[k]
        return out
    return wrapped


def per_call(tally: dict, want: dict) -> dict:
    """The launches per call of each path in `tally`; raises unless they
    are `want[path]` (the path's kernels, each launched at least once a
    call)."""
    got = {path: {k: v / row["calls"] for k, v in row.items()
                  if k != "calls"} for path, row in tally.items()}
    if got != want:
        raise AssertionError(f"launches per call {got}, want {want}")
    return got


def phase_measure_tools(root: Path, flops18: dict, smi: str) -> dict:
    """20. The measurement tools (livecell_tpu_torch/tools/) in process on
    the card at their JAX defaults' widths, each one's printed JSON
    parsed and its times finite and > 0: profile_step (T2's shape) and
    trace_summary on its trace (K1-K4 named, the busy time within
    BUSY_AGREEMENT of profile_call's for the same step, 0 < MFU <= 1,
    K1-K4 once per step); profile_transfer with and without --scan
    (K4/K5/K6 1/2/2 per step); roofline of T2 and T3 with --measure, the
    FLOPs equal to phase 18's count to 4 places; bench_roi_blocks (its
    checks, every kernel's geometry, K1/K2 once per timed forward and
    K1-K3 once per forward-backward, then K1-K3 held against their plain
    versions on its inputs for the kernels' record); check_torch_import
    on a torchvision-layout file drawn from a seed (refused at the
    zero-shot gate with JAX's message) and on the same file with the RPN
    bias leaned by +3 (tier 2); bench_serve (K1/K2 once per model call
    of its tile, frame and pipelined paths); bench_transfer_nms (K5
    twice per model call at each top-k, and held against its plain
    version on the first call's inputs: K = top-k at 7x7, K = 100 at
    14x14, B = 1); bench_nms (its profiled launches equal to its CUDA
    graph's kernel nodes) and bench_conv1 (its three rel_err <= 1e-4).
    Every launch count starts from 0 just before its tool runs."""
    from livecell_tpu_torch.config import ModelConfig
    from livecell_tpu_torch.models.mask_rcnn import (
        create_model, create_train_model)
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.parallel.train_step import build_optimizer
    from livecell_tpu_torch.tools import (
        bench_conv1, bench_nms, bench_roi_blocks, bench_serve,
        bench_transfer_nms, check_torch_import, profile_step,
        profile_transfer, roofline, trace_summary)
    from livecell_tpu_torch.tools.steps import (
        CONSTANT_LR_EPOCH, stepper, to_device)
    from livecell_tpu_torch.utils.profiling import per_call_ms

    res, cases, secs = {}, [], {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now
        torch.cuda.empty_cache()

    # (a) profile_step at T2's shape, then trace_summary on its trace.
    k14 = train_counters()
    steps = MEASURE_STEPS["profile_step"]
    trace_dir = root / "xprof"
    zeroed(k14)
    rec, lines = run_tool(profile_step, [
        "--bs", str(TRAIN_B), "--steps", str(steps), "--fixed",
        "--mask_samples", "64", "--trace", str(trace_dir)])
    ran = 1 + steps + profile_step.TRACE_STEPS + 1   # warm, timed, trace,
    launches = {k: fn.launches for k, fn in k14.items()}   # the FLOP count
    positive("profile_step", rec, ("step_ms", "img_per_sec"))
    if not (lines[-1] == rec and rec["mfu"] is not None
            and 0 < rec["mfu"] <= 1
            and launches == {k: ran for k in k14}):
        raise AssertionError(f"profile_step: {rec}, launches {launches} "
                             f"for {ran} steps")
    summary = trace_summary.summarize(str(trace_dir),
                                      profile_step.TRACE_STEPS, top=10 ** 6)
    trace_summary.print_summary(dict(summary, by_kind=summary["by_kind"][:12],
                                     by_source=summary["by_source"][:12],
                                     by_op=summary["by_op"][:12],
                                     top=summary["top"][:12]))
    names = ("roi_weights_kernel", "roi_align_fwd_kernel",
             "roi_spans_kernel", "roi_align_bwd_kernel", "match_kernel")
    ranks = {n: next((i for i, r in enumerate(summary["top"])
                      if n in r[0]), None) for n in names}
    # The same step, one call traced again by profile_call (the same busy
    # rule: the union of the device events): up to 3 readings, the first
    # within BUSY_AGREEMENT kept.
    cfg = ModelConfig(**TRAIN_CFGS["T2"])
    model = create_train_model(cfg, torch.Generator().manual_seed(0),
                               device="cuda")
    opt = build_optimizer(model, 1e-3, 1e-4, CONSTANT_LR_EPOCH)
    run = stepper(model, opt, *to_device(
        *profile_step.draw_inputs(cfg, TRAIN_B), "cuda"))
    run()
    per_step = summary["busy_ms"] / profile_step.TRACE_STEPS
    for attempt in range(3):
        prof = profile_call(run)
        gap = abs(per_step - prof["device_busy_ms"]) / prof["device_busy_ms"]
        if gap <= BUSY_AGREEMENT:
            break
    res["profile_step"] = dict(
        record=rec, launches_per_step={k: v / ran for k, v in
                                       launches.items()},
        trace_busy_ms_per_step=per_step,
        trace_idle_share=summary["idle_share"],
        trace_launches_per_step=summary["launches"]
        / profile_step.TRACE_STEPS,
        profile_call_busy_ms=prof["device_busy_ms"], busy_gap=gap,
        busy_readings=attempt + 1, kernel_ranks=ranks, top=summary["top"][:10])
    log(f"[measure] {smi} | profile_step", json.dumps(res["profile_step"]))
    if not (all(r is not None for r in ranks.values())
            and gap <= BUSY_AGREEMENT):
        raise AssertionError(f"trace_summary of profile_step: ranks {ranks}, "
                             f"busy {per_step} vs {prof['device_busy_ms']}")
    del model, opt, run
    part("a_profile_step")

    # (b) profile_transfer with and without --scan.
    k456 = {"match_anchors": cm.match_anchors,
            "ms_roi_align_fwd": cms.ms_roi_align_fwd,
            "ms_roi_align_bwd": cms.ms_roi_align_bwd}
    steps = MEASURE_STEPS["profile_transfer"]
    res["profile_transfer"] = {}
    for scan in (False, True):
        zeroed(k456)
        argv = ["--steps", str(steps), "--trace",
                "" if scan else str(root / "xprof_transfer")]
        rec, lines = run_tool(profile_transfer,
                              argv + (["--scan"] if scan else []))
        ran = 1 + steps + 1 + (0 if scan else profile_transfer.TRACE_STEPS)
        launches = {k: fn.launches for k, fn in k456.items()}
        positive("profile_transfer", rec, ("step_ms", "img_per_sec"))
        want = {"match_anchors": ran, "ms_roi_align_fwd": 2 * ran,
                "ms_roi_align_bwd": 2 * ran}
        label = "scan" if scan else "per_step"
        res["profile_transfer"][label] = dict(
            record=rec, launches_per_step={k: v / ran for k, v in
                                           launches.items()})
        log(f"[measure] {smi} | profile_transfer {label}",
            json.dumps(res["profile_transfer"][label]))
        if not (lines[-1] == rec and launches == want
                and 0 < rec.get("mfu", 0) <= 1):
            raise AssertionError(f"profile_transfer {label}: {rec}, "
                                 f"launches {launches} (want {want})")
    if not list((root / "xprof_transfer").glob("trace_*.json")):
        raise AssertionError("profile_transfer wrote no trace")
    part("b_profile_transfer")

    # (c) roofline of T2 and T3, measured.
    res["roofline"] = {}
    for label, argv in (("T2", ["--batch_size", str(TRAIN_B)]),
                        ("T3", ["--transfer", "--batch_size",
                                str(T_BATCH)])):
        rec, lines = run_tool(roofline, argv + [
            "--measure", "--steps", str(MEASURE_STEPS["roofline"])])
        positive("roofline", rec, (
            "t_tensor_ms", "t_hbm_ms", "roofline_floor_ms",
            "measured_ms_per_dispatch", "img_per_sec_per_dispatch",
            "floor_fraction", "hbm_gbytes"))
        want = round(flops18[label]["tflop"], 4)
        res["roofline"][label] = dict(record=rec, phase18_tflop=want)
        log(f"[measure] {smi} | roofline {label}: floor_fraction "
            f"{rec['floor_fraction']}", json.dumps(res["roofline"][label]))
        if not (lines[-1] == rec and rec["analytic_tensor_tflops"] == want):
            raise AssertionError(f"roofline {label}: {rec}, phase 18 counted "
                                 f"{want} TFLOP")
    part("c_roofline")

    # (d) bench_roi_blocks, its timed calls' launches counted, and K1-K3
    # on its inputs for the record.
    k123 = {k: fn for k, fn in train_counters().items()
            if k != "match_anchors"}
    tally_roi, timed = {}, []

    def counted_timer(fn, dev, **kw):
        label = (f"bench_roi_blocks K="
                 f"{bench_roi_blocks.KS[len(timed) // 2]} {fn.__name__}")
        timed.append(label)
        return per_call_ms(tallied(fn, k123, tally_roi, lambda: label), dev,
                           **kw)

    zeroed(k123)
    with patched(bench_roi_blocks, {"per_call_ms": counted_timer}):
        rows, lines = run_tool(bench_roi_blocks, [])
    for r in rows:
        positive("bench_roi_blocks", r, ("fwd_ms", "fwdbwd_ms"))
    if (lines != rows or [r["k"] for r in rows] != list(bench_roi_blocks.KS)
            or not all(g is not None for r in rows
                       for g in r["geometry"].values())):
        raise AssertionError(f"bench_roi_blocks: {rows}")
    run_launches = {"bench_roi_blocks": {
        k: fn.launches for k, fn in k123.items()}}
    per_path = per_call(tally_roi, {
        f"bench_roi_blocks K={k} {name}": {
            "roi_weights": 1, "roi_align_fwd": 1,
            "roi_align_bwd": int(name == "fwdbwd")}
        for k in bench_roi_blocks.KS for name in ("fwd", "fwdbwd")})
    res["bench_roi_blocks"] = rows
    data = bench_roi_blocks.inputs("cuda")
    feat = data["feat"]
    gen = torch.Generator().manual_seed(SEED + 20)
    for k in bench_roi_blocks.KS:
        label = f"roi_blocks K={k}"
        cases += k12_cases(cra, feat, data[k], label=label)
        wy, wx = cra.roi_weights(data[k], feat.shape[1:3], OUT, RATIO, SCALE,
                                 feat.dtype)
        g = torch.randn((feat.shape[0], k, OUT, OUT, feat.shape[3]),
                        generator=gen).to("cuda", feat.dtype)
        cases.append(k3_check(cra, g, wy, wx, tuple(feat.shape[1:3]), label))
    del data, feat
    part("d_bench_roi_blocks")

    # (e) check_torch_import: refused at the zero-shot gate, then passed
    # with the RPN objectness bias leaned by +3.
    sd = fake_torchvision_state_dict()
    torch.save(sd, root / "fake.pth")
    sd["rpn.head.cls_logits.bias"] = sd["rpn.head.cls_logits.bias"] + 3.0
    torch.save(sd, root / "leaned.pth")
    del sd
    try:
        run_tool(check_torch_import, ["--weights", str(root / "fake.pth")])
        refusal = None
    except AssertionError as e:
        refusal = str(e)
    gate = ("zero-shot RPN peak objectness ", " <= 0.7 — weights do not "
            "behave like pretrained COCO weights")
    if not (refusal and refusal.startswith(gate[0])
            and refusal.endswith(gate[1])):
        raise AssertionError(f"check_torch_import on random weights: "
                             f"{refusal!r}, not the zero-shot refusal")
    rec, _ = run_tool(check_torch_import,
                      ["--weights", str(root / "leaned.pth")])
    try:
        import torchvision  # noqa: F401
        tier = 1
    except ImportError:
        tier = 2
    res["check_torch_import"] = dict(refused=refusal, leaned=rec)
    log("[measure] check_torch_import", json.dumps(
        res["check_torch_import"]))
    if rec["tier"] != tier or not rec["peak_objectness"] > 0.7:
        raise AssertionError(f"check_torch_import, leaned bias: {rec}")
    part("e_check_torch_import")

    # (f) the serving and study benchmarks. bench_serve's and
    # bench_transfer_nms' model calls have their launches counted, and K5
    # is held against its plain version on the first transfer call's
    # inputs at each top-k.
    k12 = {"roi_weights": cra.roi_weights,
           "roi_align_fwd": cra.roi_align_fwd}
    tally_serve, scope = {}, ["frame"]

    def counted_model(*args, **kw):
        model = create_model(*args, **kw)
        model.inference_forward = tallied(
            model.inference_forward, k12, tally_serve,
            lambda images: "bench_serve " + (
                "tile" if images.shape[0] == 1 else scope[0]))
        return model

    def pipelined(*args, **kw):
        scope[0] = "pipelined frame"
        return bench_pipelined_serve(*args, **kw)

    bench_pipelined_serve = bench_serve.bench_pipelined_serve
    zeroed(k12)
    with patched(bench_serve, {"create_model": counted_model,
                               "bench_pipelined_serve": pipelined}):
        rows, lines = run_tool(bench_serve, [])
    for r in rows:
        positive("bench_serve", r, ("value",) + (
            ("device_ms",) if "device_ms" in r else ()))
    if lines != rows or len(rows) != 4:
        raise AssertionError(f"bench_serve: {rows}")
    run_launches["bench_serve"] = {k: fn.launches for k, fn in k12.items()}
    per_fwd = 2 if ModelConfig().decode_proposals else 1
    per_path.update(per_call(tally_serve, {
        f"bench_serve {path}": dict.fromkeys(k12, per_fwd)
        for path in ("tile", "frame", "pipelined frame")}))
    res["bench_serve"] = rows
    part("f_bench_serve")

    k5 = {"ms_roi_align_fwd": cms.ms_roi_align_fwd}
    rec5 = Recorder(cms.ms_roi_align_fwd, 2)
    tally_nms = {}

    def counted_transfer(cfg, *args, **kw):
        model = create_transfer_model(cfg, *args, **kw)
        label = f"bench_transfer_nms topk {cfg.rpn_post_nms}"
        model.inference_forward = tallied(
            scoped(model.inference_forward, [rec5], label), k5, tally_nms,
            lambda images: label)
        return model

    create_transfer_model = bench_transfer_nms.create_transfer_model
    zeroed(k5)
    with patched(bench_transfer_nms,
                 {"create_transfer_model": counted_transfer}), \
            patched(cms, {"ms_roi_align_fwd": rec5}):
        rec, lines = run_tool(bench_transfer_nms, [
            "--steps", str(MEASURE_STEPS["bench_transfer_nms"])])
    positive("bench_transfer_nms", rec, ("topk_512_ms", "topk_1000_ms"))
    if lines != [rec]:
        raise AssertionError(f"bench_transfer_nms: {rec}")
    run_launches["bench_transfer_nms"] = {k: fn.launches for k, fn in k5.items()}
    per_path.update(per_call(tally_nms, {
        f"bench_transfer_nms topk {k}": {"ms_roi_align_fwd": 2}
        for k in (512, 1000)}))
    # The box head's proposals (K = top-k, 7x7), then the mask head's
    # detections (K = 100, 14x14), at B = 1.
    for label, calls in rec5.calls.items():
        for feats, boxes, _, out_size, _ in calls:
            cases += ms_roi_cases(cms, list(feats), boxes, out_size, label,
                                  backward=False)
    del rec5
    res["bench_transfer_nms"] = rec
    part("g_bench_transfer_nms")
    rows, lines = run_tool(bench_nms, [])
    for r in rows:
        positive("bench_nms", r, ("value", "launches", "graph_launches"))
    if lines != rows or len(rows) != 3 or not all(
            r["launches"] == r["graph_launches"] for r in rows):
        raise AssertionError(f"bench_nms: {rows}")
    res["bench_nms"] = rows
    part("h_bench_nms")
    rows, lines = run_tool(bench_conv1, [])
    checks = [r for r in rows if "check" in r]
    for r in rows[len(checks):]:
        positive("bench_conv1", r, ("fwd_ms", "fwd_wgrad_ms"))
    if lines != rows or len(checks) != 3 or not all(
            r["rel_err"] <= 1e-4 for r in checks):
        raise AssertionError(f"bench_conv1: {rows}")
    res["bench_conv1"] = rows
    part("i_bench_conv1")

    res.update(parts_s=secs, cases=cases, launches_per_call=per_path,
               launches_per_run=run_launches)
    log(f"[measure] launches per call {json.dumps(per_path)}; per run "
        f"{json.dumps(run_launches)}")
    log(f"[measure] parts (s) {json.dumps(secs)}")
    return res


# ---------------------------------------------------------------------------
# The real-data runbook (phase 21).
# ---------------------------------------------------------------------------
# Cell (g)'s size: a "sparse" LIVECell source tree of 14/3/3 frames,
# tiled 70/15/15 -> 350/75/75 tiles. The runbook's knobs: JAX's epochs
# and batch, NUM_IMAGES cut from 100 to the tree's 20 frames.
RUNBOOK_FRAMES = (14, 3, 3)
RUNBOOK_TILES = {"train": 350, "val": 75, "test": 75}
RUNBOOK_ENV = {"NUM_IMAGES": "20", "EPOCHS": "10", "BATCH_SIZE": "16",
               "SKIP_DOWNLOAD": "1"}
# Refuses at once: there is no network, and the weights step must not
# hang.
REFUSED_URL = "http://127.0.0.1:9/"
# The children of a first run, in order, and each one's name in the
# phase's line.
RUNBOOK_STAGES = (("data.validate", "validate"), ("data.tiling", "tiling"),
                  ("data.dvc", "dvc data"), ("data.dvc", "dvc data_split"),
                  ("train.train_custom", "train quirk"),
                  ("train.train_custom", "train flagship"),
                  ("serve.visualize", "visualize"))


def runbook(rrl, work: Path, env: dict, log: Path) -> dict:
    """One run_real_livecell.main over `work` with its default runner
    (real child processes, their output streamed), its output captured:
    its exit code, the records of its children (None when it exited
    early), the children it started (the "== module ==" lines it prints
    before each), its output, and each child's kernel launches, which
    the children append to `log` at their exit (ops/launch_log.py)."""
    import io
    from livecell_tpu_torch.ops import launch_log
    out, err = io.StringIO(), io.StringIO()
    records, rc = None, 0
    try:
        with patched(rrl, {"TV_URL": REFUSED_URL}), \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            records = rrl.main([str(work)],
                               env={**env, launch_log.ENV: str(log)})
    except SystemExit as e:
        rc = e.code
    text = out.getvalue()
    started = [ln[3:-3] for ln in text.splitlines()
               if ln.startswith("== ") and ln.endswith(" ==")
               and " " not in ln[3:-3]]
    # One line a child, in the order they ended; the module from the
    # file `python -m` ran.
    rows = [json.loads(ln) for ln in log.read_text().splitlines()] \
        if log.exists() else []
    launches = [(Path(r["argv"][0]).with_suffix("").as_posix().split(
        "livecell_tpu_torch/", 1)[-1].replace("/", "."), r["launches"])
        for r in rows]
    return dict(rc=rc, records=records, started=started, out=text,
                err=err.getvalue(), launches=launches)


def runbook_launches(run: dict, names) -> dict:
    """{stage name: its child's launches}; raises unless one child of the
    port's modules wrote its counts for each child started, in order."""
    mods = [m for m, _ in run["launches"]]
    if mods != run["started"]:
        raise AssertionError(f"runbook: launch counts from {mods}, "
                             f"children {run['started']}")
    return {name: counts for name, (_, counts) in zip(names,
                                                      run["launches"])}


def runbook_want(tiles: dict, names) -> dict:
    """The launches each runbook child must make: the trainers K1-K4 once
    a training step, K1/K2 once a RoIAlign pass of each eval batch
    (validation every epoch, the test box metrics and the AP sweep; two
    passes with decode_proposals); visualize K1/K2 twice a test frame
    (a batch of its 25 tiles, decode_proposals); the data stages none."""
    epochs, batch = int(RUNBOOK_ENV["EPOCHS"]), int(RUNBOOK_ENV["BATCH_SIZE"])
    steps = tiles["train"] // batch * epochs
    evals = epochs * math.ceil(tiles["val"] / batch) + \
        2 * math.ceil(tiles["test"] / batch)
    zero = dict.fromkeys(("roi_weights", "roi_align_fwd", "roi_align_bwd",
                          "match_anchors", "ms_roi_align_fwd",
                          "ms_roi_align_bwd"), 0)

    def trainer(passes):
        return {**zero, "roi_weights": steps + passes * evals,
                "roi_align_fwd": steps + passes * evals,
                "roi_align_bwd": steps, "match_anchors": steps}
    frames = RUNBOOK_FRAMES[2]
    want = {"train quirk": trainer(1), "train flagship": trainer(2),
            "visualize": {**zero, "roi_weights": 2 * frames,
                          "roi_align_fwd": 2 * frames}}
    return {name: want.get(name, zero) for name in names}


def printed_metrics(stdout: str) -> dict:
    """A trainer child's printed validation F1 (one an epoch), its test
    line and its test mask AP line."""
    import re
    val = [float(m.group(1)) for m in re.finditer(
        r"  Validation: .* F1 ([\d.]+)", stdout)]
    test = re.search(r"  Test: IoU ([\d.]+) \| P ([\d.]+) \| R ([\d.]+) "
                     r"\| F1 ([\d.]+)", stdout)
    ap = re.search(r"  Mask AP: ([\d.]+) \(AP50 ([\d.]+), AP75 ([\d.]+)\)",
                   stdout)
    return dict(
        val_f1=val,
        test=test and dict(zip(("iou", "precision", "recall", "f1"),
                               map(float, test.groups()))),
        mask_ap=ap and dict(zip(("AP", "AP50", "AP75"),
                                map(float, ap.groups()))))


def runbook_witness(work: Path, printed: dict) -> dict:
    """Both runbook checkpoints in process over the test split: eval_ckpt
    (box P/R/F1, mask and box AP, the count of detections the eval step
    returns for the 75 test tiles and their best score) and oracle_probe
    (arm A the mask-target ceiling, B the mask head at the GT boxes, C
    the detections' best box and mask IoU for each GT), each with K1/K2
    counted per batch. eval_ckpt must give the trainer's printed test
    F1 and mask AP within 1.5e-4 (both are printed to 4 digits)."""
    import io
    from livecell_tpu_torch.tools import eval_ckpt, oracle_probe
    from livecell_tpu_torch.tools.run_real_livecell import LIFTED_CAPS
    counters = {k: fn for k, fn in eval_counters().items()
                if k != "ms_roi_align_fwd"}
    split = str(work / "data_split")
    n_test = RUNBOOK_TILES["test"]
    out = {}
    for name, caps, passes in (("custom_quirk", [], 1),
                               ("custom_fixed", LIFTED_CAPS, 2)):
        ckpt = str(work / "models" / f"{name}.ckpt")
        tally = dict(rows=0, detections=0, best_score=0.0)
        make = eval_ckpt.make_eval_step

        def counted(*a, **k):
            step = make(*a, **k)

            def run(images):
                det = step(images)
                take = min(det.valid.shape[0], n_test - tally["rows"])
                valid = det.valid[:take]
                tally["rows"] += take
                tally["detections"] += int(valid.sum())
                if bool(valid.any()):
                    tally["best_score"] = max(
                        tally["best_score"],
                        float(det.scores[:take][valid].max()))
                return det
            return run
        zeroed(counters)
        with patched(eval_ckpt, {"make_eval_step": counted}):
            row, _ = run_tool(eval_ckpt, ["--ckpt", ckpt, "--data_dir",
                                          split] + caps)
        torch.cuda.synchronize()
        batches = math.ceil(n_test / 16)
        eval_l = {k: c.launches / batches for k, c in counters.items()}
        zeroed(counters)
        with contextlib.redirect_stdout(io.StringIO()):
            probe = oracle_probe.main(["--ckpt", ckpt, "--data_dir", split,
                                       "--batch_size", "16"] + caps)
        torch.cuda.synchronize()
        probe_l = {k: c.launches / batches for k, c in counters.items()}
        torch.cuda.empty_cache()
        mine = printed[name]
        gaps = {"f1": row["f1"] - mine["test"]["f1"],
                **{f"mask_{k}": row[f"mask_{k}"] - mine["mask_ap"][k]
                   for k in ("AP", "AP50", "AP75")}}
        out[name] = dict(
            eval_ckpt=row, detections=tally["detections"],
            tiles=tally["rows"], best_score=tally["best_score"],
            oracle={arm: {k: probe[arm][k] for k in
                          ("n", "mean", "frac_ge_50", "frac_ge_75")}
                    for arm in oracle_probe.ARMS if arm in probe},
            gaps=gaps, launches_per_eval_batch=eval_l,
            launches_per_oracle_batch=probe_l)
        if not (all(abs(g) <= 1.5e-4 for g in gaps.values())
                and tally["rows"] == n_test
                and eval_l == {"roi_weights": passes,
                               "roi_align_fwd": passes}
                and probe_l == {"roi_weights": passes + 1,
                                "roi_align_fwd": passes + 1}):
            raise AssertionError(f"runbook witness {name}: "
                                 f"{json.dumps(out[name])}")
    return out


def ckpt_mtimes(models: Path) -> dict:
    return {str(p.relative_to(models)): p.stat().st_mtime_ns
            for p in sorted(models.rglob("*")) if p.is_file()}


def pointer_md5(path: Path) -> str:
    return next(ln.split(": ", 1)[1] for ln in path.read_text().splitlines()
                if ln.startswith("- md5: "))


def phase_runbook(root: Path, smi: str) -> dict:
    """21. tools/run_real_livecell.py:main on a "sparse" LIVECell source
    tree (tools/synth_splits.make_fake_livecell, 14/3/3 grey TIFF
    frames), each child a real process, NUM_IMAGES=20 SKIP_DOWNLOAD=1
    and JAX's EPOCHS=10 BATCH_SIZE=16, the weights' URL refused: validate
    passes, 25 tiles a frame (350/75/75), both pointers equal
    data/dvc.py's hash of their trees, both custom checkpoints load and
    name their model, each trainer prints its test mask AP (the
    flagship's AP50 >= MIN_TEST_MASK_AP50), the transfer stage is
    skipped with the WARNING, one panel a test frame. A second run
    retrains nothing; a third, with a seeded torchvision-layout file at
    the weights' path, exits 1 on the prefix pin and trains nothing.
    Each child writes its kernel launches at its exit (ops/launch_log.py)
    and every run's must be runbook_want's: K1-K4 in both trainers, K1/K2
    in visualize, none in the data stages. Then runbook_witness
    evaluates both checkpoints in process (detections, F1, the oracle
    arms). Phase 15 holds K1-K4 against their plain versions on the
    trainer's inputs."""
    import os
    from livecell_tpu_torch.data import dvc
    from livecell_tpu_torch.data.png import read_png
    from livecell_tpu_torch.tools import run_real_livecell as rrl
    from livecell_tpu_torch.tools.synth_splits import (
        MODES, make_fake_livecell)
    from livecell_tpu_torch.train import checkpoint

    work = root / "livecell_run"
    make_fake_livecell(work / "data", images_per_split=RUNBOOK_FRAMES,
                       seed=SEED + 21, **MODES["sparse"])
    env = {**os.environ, **RUNBOOK_ENV}
    models = work / "models"

    def failed(label: str, run: dict):
        log(run["out"][-4000:])
        log(run["err"][-4000:])
        raise AssertionError(f"runbook {label}: exit {run['rc']}, "
                             f"children {run['started']}")

    names = [name for _, name in RUNBOOK_STAGES]
    first = runbook(rrl, work, env, root / "launches_first.jsonl")
    if first["rc"] != 0 or first["started"] != [
            m for m, _ in RUNBOOK_STAGES]:
        failed("first run", first)
    recs = first["records"]
    seconds = {name: r["seconds"]
               for (_, name), r in zip(RUNBOOK_STAGES, recs)}
    validate = recs[0]
    tiles = {s: len(list((work / "data_split" / s / "images").glob(
        "*.png"))) for s in ("train", "val", "test")}
    printed = {name: printed_metrics(r["stdout"]) for r, name in zip(
        recs[4:6], ("custom_quirk", "custom_fixed"))}
    aps = {name: m["mask_ap"] for name, m in printed.items()}
    ckpts = {}
    for name in ("custom_quirk", "custom_fixed"):
        kind, cfg, sd = checkpoint.load_model_state(
            str(models / f"{name}.ckpt"), "cuda")
        ckpts[name] = dict(model_type=kind,
                           decode_proposals=cfg.decode_proposals,
                           heads_all_images=cfg.heads_all_images,
                           tensors=len(sd))
        del sd
    torch.cuda.empty_cache()
    panels = sorted(p.name for p in (work / "visualizations").glob(
        "*_GT_VS_PREDICTIONS.png"))
    want_panels = [f"A172_Phase_test_{i:03d}_GT_VS_PREDICTIONS.png"
                   for i in range(RUNBOOK_FRAMES[2])]
    panel_shape = read_png(work / "visualizations" / want_panels[0]).shape \
        if panels == want_panels else None
    data_md5 = pointer_md5(work / "data.dvc")
    res = dict(
        rc=first["rc"], children=first["started"], stage_s=seconds,
        tiling_frames_per_s=sum(RUNBOOK_FRAMES) / seconds["tiling"],
        validate_ok=validate["stdout"].count("[OK]") == 3
        and "[FAIL]" not in validate["stdout"],
        tiles=tiles, test_mask_ap=aps,
        trainer_f1={name: dict(val=m["val_f1"], test=m["test"])
                    for name, m in printed.items()},
        launches={"first": runbook_launches(first, names)},
        checkpoints=ckpts,
        warning=[ln for ln in first["out"].splitlines()
                 if ln.startswith("WARNING")],
        panels=panels, panel_shape=panel_shape,
        data_dvc_equal=data_md5 == dvc.dir_hash(
            dvc.dir_manifest(work / "data")))
    if not (res["validate_ok"]
            and tiles == RUNBOOK_TILES
            and res["launches"]["first"] == runbook_want(tiles, names)
            and all(m["test"] and len(m["val_f1"]) == int(
                RUNBOOK_ENV["EPOCHS"]) for m in printed.values())
            and all(c["model_type"] == "custom" for c in ckpts.values())
            and ckpts["custom_fixed"]["decode_proposals"]
            and ckpts["custom_fixed"]["heads_all_images"]
            and not ckpts["custom_quirk"]["decode_proposals"]
            and all(aps.values()) and len(res["warning"]) == 1
            and res["warning"][0].startswith(
                "WARNING: torchvision weights unreachable")
            and not (work / rrl.WEIGHTS).exists()
            and not (models / "transfer_real.ckpt").exists()
            and panels == want_panels and panel_shape is not None
            and res["data_dvc_equal"]):
        log(f"[runbook] {json.dumps(res)}")
        failed("first run checks", first)

    # The re-run: validate, both pointers and visualize only; nothing is
    # retrained. The pointers now cover the trainers' dataset caches too.
    before = ckpt_mtimes(models)
    rerun = ("validate", "dvc data", "dvc data_split", "visualize")
    second = runbook(rrl, work, env, root / "launches_second.jsonl")
    if second["rc"] != 0:
        failed("re-run", second)
    res["rerun_children"] = second["started"]
    res["rerun_s"] = {name: r["seconds"] for name, r in zip(
        rerun, second["records"])}
    res["launches"]["second"] = runbook_launches(second, rerun)
    res["pointers_equal"] = {
        name: pointer_md5(work / f"{name}.dvc") == dvc.dir_hash(
            dvc.dir_manifest(work / name)) for name in ("data", "data_split")}
    if not (second["started"] == ["data.validate", "data.dvc", "data.dvc",
                                  "serve.visualize"]
            and ckpt_mtimes(models) == before
            and all(res["pointers_equal"].values())
            and res["launches"]["second"] == runbook_want(tiles, rerun)):
        log(f"[runbook] {json.dumps(res)}")
        failed("re-run checks", second)

    # Weights that fail the pin: exit 1 before any child of the transfer
    # stage, nothing trained.
    torch.save(fake_torchvision_state_dict(), work / rrl.WEIGHTS)
    weights = str((work / rrl.WEIGHTS).relative_to(models))
    third = runbook(rrl, work, env, root / "launches_third.jsonl")
    errors = [ln for ln in third["err"].splitlines()
              if ln.startswith("ERROR")]
    refused = ("validate", "dvc data", "dvc data_split")
    res["refused"] = dict(rc=third["rc"], children=third["started"],
                          error=errors,
                          launches=runbook_launches(third, refused))
    if not (third["rc"] == 1 and len(errors) == 1
            and errors[0].startswith("ERROR: weight sha256 prefix ")
            and third["started"] == ["data.validate", "data.dvc",
                                     "data.dvc"]
            and {k: v for k, v in ckpt_mtimes(models).items()
                 if k != weights} == before
            and not (models / "transfer_real.ckpt").exists()
            and res["refused"]["launches"] == runbook_want(tiles, refused)):
        log(f"[runbook] {json.dumps(res)}")
        failed("refused weights", third)

    res["witness"] = runbook_witness(work, printed)

    log(f"[runbook] {smi} | {json.dumps(res)}")
    fixed = aps["custom_fixed"]
    log(f"[runbook] {smi} | stage seconds {json.dumps(seconds)}; tiling "
        f"{res['tiling_frames_per_s']:.3f} frames/s (the child's wall "
        f"time, start-up included); test mask AP quirk "
        f"{aps['custom_quirk']['AP']:.4f} / flagship {fixed['AP']:.4f} "
        f"(AP50 {fixed['AP50']:.4f})")
    for name, w in res["witness"].items():
        m = printed[name]
        log(f"[runbook] {smi} | {name}: validation F1 by epoch "
            f"{m['val_f1']}; test F1 {m['test']['f1']:.4f} (P "
            f"{m['test']['precision']:.4f}, R {m['test']['recall']:.4f}); "
            f"{w['detections']} detections on {w['tiles']} test tiles, "
            f"best score {w['best_score']:.4f}; box AP50 "
            f"{w['eval_ckpt']['box_AP50']:.4f}; oracle arms "
            f"{json.dumps(w['oracle'])}")
    if not fixed["AP50"] >= MIN_TEST_MASK_AP50:
        raise AssertionError(f"runbook: flagship test mask AP50 "
                             f"{fixed['AP50']:.4f} < {MIN_TEST_MASK_AP50}")
    return res


JAX_CKPT = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_ckpt"
# Held against JAX's f32 forward on the CPU (tests/jax_ckpt_fixtures.py,
# "highest" matmul precision) with cuDNN in f32 (TF32 off): the first
# TOP_K detections by score, boxes in pixels, scores, mask-probability
# sums relative (tests/test_torch_jax_fixtures.py holds the CPU port to
# the same).
JAX_CKPT_TOL = {"box_atol": 1e-2, "score_atol": 1e-4, "mask_rtol": 1e-3}
JAX_CKPT_TOP_K = 20
JAX_RESUME_FRAMES = (("train", 2), ("val", 1), ("test", 1))
JAX_RESUME_CLI = ["--batch_size", "16", "--lr", "0.001", "--lr_step_size",
                  "1", "--num_epochs", "3", "--fixed_heads",
                  "--decode_proposals", "--mask_samples", "16"]


def leaf_hashes(payload) -> dict:
    """{leaf path: {shape, dtype, sha256}} of a loaded checkpoint's arrays,
    as tests/jax_ckpt_fixtures.py:leaf_table lists them."""
    import hashlib
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, np.ndarray):
            a = np.ascontiguousarray(node)
            out[path] = {"shape": list(a.shape), "dtype": a.dtype.str,
                         "sha256": hashlib.sha256(a.tobytes()).hexdigest()}

    walk({k: v for k, v in payload.items() if k != "model_config"}, "")
    return out


def held_to_jax(label: str, boxes, scores, mask_sums, want: dict) -> dict:
    """The first JAX_CKPT_TOP_K detections by score against JAX's
    recorded ones (all of them, and as many, where JAX has fewer)."""
    k = min(JAX_CKPT_TOP_K, len(want["scores"]))
    got_o = np.argsort(-np.asarray(scores), kind="stable")[:k]
    want_o = np.argsort(-np.asarray(want["scores"]), kind="stable")[:k]
    errs = {
        "box": float(np.abs(np.asarray(boxes)[got_o]
                            - np.asarray(want["boxes"])[want_o]).max()),
        "score": float(np.abs(np.asarray(scores)[got_o]
                              - np.asarray(want["scores"])[want_o]).max()),
        "mask_rel": float((np.abs(np.asarray(mask_sums)[got_o]
                                  - np.asarray(want["mask_prob_sums"])[want_o])
                           / np.abs(np.asarray(want["mask_prob_sums"])[want_o])
                           ).max())}
    res = dict(label=label, detections=len(scores),
               jax_detections=len(want["scores"]), compared=k, err=errs,
               tol=JAX_CKPT_TOL)
    log("[jax ckpt]", json.dumps(res))
    if not (len(scores) >= k and (len(want["scores"]) > JAX_CKPT_TOP_K
                                  or len(scores) == len(want["scores"]))
            and errs["box"] <= JAX_CKPT_TOL["box_atol"]
            and errs["score"] <= JAX_CKPT_TOL["score_atol"]
            and errs["mask_rel"] <= JAX_CKPT_TOL["mask_rtol"]):
        raise AssertionError(f"jax ckpt {label}: {res}")
    return res


def phase_jax_ckpt(root: Path, frame: np.ndarray, smi: str) -> dict:
    """22. The JAX package's checkpoints on the card (see the module's
    doc): read, hashed, served and resumed."""
    from livecell_tpu_torch import native
    from livecell_tpu_torch.models import mask_rcnn
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.parallel.train_step import scheduled_lr
    from livecell_tpu_torch.serve.app import InferenceEngine
    from livecell_tpu_torch.tools.bench_ckpt_read import read_stats
    from livecell_tpu_torch.train import checkpoint, jax_checkpoint
    from livecell_tpu_torch.train import train_custom

    lib = native.library_path()
    lib.unlink(missing_ok=True)
    native.library.cache_clear()
    t0 = time.perf_counter()
    if native.backend() != "cpp" or not lib.exists():
        raise AssertionError("jax ckpt: the native library did not build")
    res = {"native_build_s": time.perf_counter() - t0}
    tables = json.loads((JAX_CKPT / "leaves.json").read_text())
    want = json.loads((JAX_CKPT / "outputs.json").read_text())
    for name in ("custom", "transfer"):
        got = leaf_hashes(jax_checkpoint.load(JAX_CKPT / name))
        if got != tables[name]:
            bad = sorted(k for k in set(got) | set(tables[name])
                         if got.get(k) != tables[name].get(k))
            raise AssertionError(f"jax ckpt {name}: leaves differ {bad[:5]}")
        row = read_stats(JAX_CKPT / name, repeat=3)
        res[f"read_{name}"] = row
        log(f"[jax ckpt] {smi} | read {name}: {len(got)} leaves equal "
            f"leaves.json;", json.dumps(row))

    # The custom checkpoint served through the engine on its tile, K1/K2's
    # inputs kept for their plain versions.
    rec12 = {k: Recorder(getattr(cra, k), 2)
             for k in ("roi_weights", "roi_align_fwd")}
    eng = InferenceEngine(str(JAX_CKPT / "custom"))
    tile = np.load(JAX_CKPT / "tile_custom.npy")
    per_fwd = 2 if eng.model.cfg.decode_proposals else 1
    with patched(cra, rec12):
        served = scoped(check_served, rec12.values(), "tile")(
            "jax custom checkpoint, its tile", eng, tile, rec12,
            {k: per_fwd for k in rec12})
    cases = recorded_k12_cases(cra, rec12, "tile", "jax ckpt custom tile")
    del rec12
    boxes, scores, _ = eng.predict(tile, 0.0)
    with torch.inference_mode():
        det = eng.model.inference_forward(torch.from_numpy(
            tile[None].astype(np.float32) / 255.0).cuda())
    v = det.valid[0]
    sums = det.mask_probs[0][v].float().reshape(int(v.sum()), -1).sum(1)
    res["custom"] = dict(served=served, **held_to_jax(
        "custom tile", boxes, scores, sums.cpu().numpy(), want["custom"]))
    del eng, det
    torch.cuda.empty_cache()

    # The transfer checkpoint (no sidecar: TransferConfig(), f32).
    kind, cfg, sd = checkpoint.load_model_state(
        str(JAX_CKPT / "transfer"), model_type="transfer")
    model = create_transfer_model(dataclasses.replace(
        cfg, compute_dtype="float32"))
    model.load_state_dict(sd, strict=True)
    rec5 = Recorder(cms.ms_roi_align_fwd, 2)
    k5 = {"ms_roi_align_fwd": rec5, "ms_roi_align_bwd": cms.ms_roi_align_bwd}
    eng = InferenceEngine(model=model, model_type="transfer")
    tile = np.load(JAX_CKPT / "tile_transfer.npy")
    with patched(cms, {"ms_roi_align_fwd": rec5}):
        served = scoped(check_served, [rec5], "tile")(
            "jax transfer checkpoint, its tile", eng, tile, k5,
            {"ms_roi_align_fwd": 2, "ms_roi_align_bwd": 0})
        framed = scoped(check_served, [rec5], "frame")(
            "jax transfer checkpoint, request (a)'s frame", eng, frame, k5,
            {"ms_roi_align_fwd": 2, "ms_roi_align_bwd": 0})
    # K5 on both passes of each request (the proposals', then the
    # detections').
    ms_cases = []
    for scope, calls in rec5.calls.items():
        for feats, boxes, _, out_size, _ in calls:
            ms_cases += ms_roi_cases(cms, list(feats), boxes, out_size,
                                     f"jax ckpt transfer {scope}",
                                     backward=False)
    for c in ms_cases:
        log("[kernels]", json.dumps(c))
    cases += ms_cases
    del rec5
    boxes, scores, _ = eng.predict(tile, 0.0)
    with torch.inference_mode():
        det = model.inference_forward(torch.from_numpy(
            tile[None].astype(np.float32) / 255.0).cuda())
    v = det.valid[0]
    sums = det.mask_probs[0][v].float().reshape(int(v.sum()), -1).sum(1)
    res["transfer"] = dict(served=served, frame=framed, **held_to_jax(
        "transfer tile", boxes, scores, sums.cpu().numpy(),
        want["transfer"]))
    del eng, model, det, sd
    torch.cuda.empty_cache()

    # The custom checkpoint resumed by the trainer CLI for one epoch.
    split = root / "split"
    draw_split(split, SEED + 22, "sparse", JAX_RESUME_FRAMES)
    ckpt = root / "jax_custom.ckpt"
    shutil.copytree(JAX_CKPT / "custom", ckpt)
    counters = train_counters()
    # Each kernel's inputs from the first resumed step.
    rec = {k: Recorder(fn, 1) for k, fn in counters.items()}
    train_l = {}
    with patched(cra, {k: rec[k] for k in
                       ("roi_weights", "roi_align_fwd", "roi_align_bwd")}), \
            patched(mask_rcnn, {"match_anchors": rec["match_anchors"]}):
        out, total = run_cli(
            train_custom, ["--data_dir", str(split), "--resume", str(ckpt)]
            + JAX_RESUME_CLI, root,
            {"train_epoch": scoped(counted(
                train_custom.train_epoch, counters, train_l),
                list(rec.values()), "train")}, counters)
    spe = out["steps_per_epoch"]
    group = out["optimizer"].param_groups[0]
    # optax's schedule of the flags (train_custom.py:build_optimizer):
    # 1e-3 * 0.1 ** ((count // steps_per_epoch) // lr_step_size); the
    # checkpoint's count is 2, the last update of the epoch had 1 + spe.
    lr_first = 1e-3 * 0.1 ** ((2 // spe) // 1)
    lr_want = 1e-3 * 0.1 ** (((1 + spe) // spe) // 1)
    meta = json.loads((root / out["model_path"] / "meta.json").read_text())
    res["resume"] = dict(
        steps_per_epoch=spe, epochs=len(out["epoch_seconds"]),
        saved_epoch=meta["epoch"], schedule_step=group["schedule_step"],
        first_lr=scheduled_lr(dict(group, schedule_step=2)),
        first_lr_want=lr_first, last_lr=group["lr"], lr_want=lr_want,
        train_losses=out["train_losses"], launches=total,
        launches_per_step={k: n / spe for k, n in train_l.items()},
        epoch_s=out["epoch_seconds"])
    log("[jax ckpt] resume:", json.dumps(res["resume"]))
    if not (len(out["epoch_seconds"]) == 1 and meta["epoch"] == 3
            and group["schedule_step"] == 2 + spe
            and abs(group["lr"] - lr_want) <= 1e-7 * lr_want
            and abs(res["resume"]["first_lr"] - lr_first) <= 1e-7 * lr_first
            and np.isfinite(out["train_losses"]).all()
            and train_l == {k: spe for k in counters}):
        raise AssertionError(f"jax ckpt resume: {res['resume']}")
    del out
    torch.cuda.empty_cache()
    res["cases"] = cases + cli_kernel_cases(cra, cm, rec, "jax ckpt resume")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from livecell_tpu_torch.config import ModelConfig, TileConfig
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.ops import _build
    from livecell_tpu_torch.ops import cuda_match as cm
    from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve.app import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"opt_einsum {torch.backends.opt_einsum.is_available()}")

    # 2. build
    with Phase(2, "build"):
        logs = _build.build_all()
        log(f"[build] {sorted(logs)}")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions: K1/K2 at the serving
    # shapes, then K4, K3 and K1/K2 at the training shapes.
    with Phase(3, "kernels"):
        cases = phase_kernels(cra)
        cases += phase_train_kernels(cra, cm)

    # 4. serve
    tcfg = TileConfig()
    cfg = ModelConfig()
    frame = synthetic_frame(tcfg.frame_height, tcfg.frame_width, SEED)
    tile = frame[:tcfg.tile_height, :tcfg.tile_width]
    with Phase(4, "serve"):
        model = create_model(cfg, torch.Generator().manual_seed(SEED))
        eng = InferenceEngine(model=model)
        req_a = serve(eng, frame, cra, 1, "a: frame, reference defaults")
        req_b = serve(eng, tile, cra, 1, "b: 300x222 tile")
        prof = profile_request(eng, frame)
        log("[profile a]", json.dumps(prof))
        del eng, model
        model_c = create_model(dataclasses.replace(cfg, decode_proposals=True),
                               torch.Generator().manual_seed(SEED))
        eng_c = InferenceEngine(model=model_c, dets=256, infer_nms=0.7,
                                det_nms=0.6)
        req_c = serve(eng_c, frame, cra, 2,
                      "c: frame, decode_proposals --dets 256 --infer_nms 0.7 "
                      "--det_nms 0.6")
        log("[profile c]", json.dumps(profile_request(eng_c, frame)))
        del eng_c, model_c
        torch.cuda.empty_cache()

    # 5. end to end, kernel vs plain RoIAlign, f32
    with Phase(5, "serve end to end"):
        phase_serve_e2e(cfg, tcfg, frame)

    # 6. train: T1 and T2 at batch 32 through train_epoch, from a pool of
    # synthetic tiles on the card.
    with Phase(6, "train"):
        pool = make_pool(cfg, POOL_TILES, "cuda", SEED)
        train = {}
        for label, kw in TRAIN_CFGS.items():
            train[label], tmodel, topt = phase_train(
                label, dataclasses.replace(cfg, **kw), pool, TRAIN_B, "cuda")
        torch.cuda.empty_cache()

    # 7. train end to end, kernel vs plain, f32, batch 4 (T2).
    with Phase(7, "train end to end"):
        phase_train_e2e(dataclasses.replace(cfg, **TRAIN_CFGS["T2"]), pool,
                        4, "cuda")

    # 8. checkpoint round trip of the T2 model, served.
    with Phase(8, "checkpoint"):
        phase_checkpoint(tmodel, topt, "cuda", tile)
        del tmodel, topt, pool
        torch.cuda.empty_cache()

    # 9.-12. the transfer model: its kernels at its shapes, a frame
    # request, T3 training, and the f32 kernel-vs-plain step.
    with Phase(9, "transfer kernels"):
        cases += phase_transfer_kernels(cms, cm)
        torch.cuda.empty_cache()
    with Phase(10, "transfer serve"):
        req_d = phase_transfer_serve(frame, tcfg)
        torch.cuda.empty_cache()
    with Phase(11, "transfer train"):
        t3 = phase_transfer_train()
        torch.cuda.empty_cache()
    with Phase(12, "transfer end to end"):
        phase_transfer_e2e()
        torch.cuda.empty_cache()

    # 13.-14. data and evaluation: a 375-tile split drawn, tiled, packed
    # and held on the card, both models evaluated over it.
    with tempfile.TemporaryDirectory() as tmp:
        with Phase(13, "data"):
            data, pds, dd = phase_data(Path(tmp))
            del dd
        with Phase(14, "evaluation"):
            evals = phase_eval(pds)
    cases += evals["cases"]
    del pds
    torch.cuda.empty_cache()

    # 15.-16. the trainer CLIs, each on its own "sparse" split and from
    # its own working directory, both removed when the phase ends; their
    # checkpoints are copied aside for phase 17, and the custom one with
    # its split for phase 19.
    # 17. the serve front ends over both trained checkpoints.
    with tempfile.TemporaryDirectory() as kept:
        ckpts = {"custom": str(Path(kept) / "custom"),
                 "transfer": str(Path(kept) / "transfer")}
        sparse = Path(kept) / "sparse"
        with tempfile.TemporaryDirectory() as tmp:
            with Phase(15, "custom trainer CLI"):
                cli_custom = phase_custom_cli(Path(tmp), frame)
            shutil.copytree(Path(tmp) / cli_custom["model_path"],
                            ckpts["custom"])
            shutil.copytree(tmp, sparse, ignore=shutil.ignore_patterns(
                "models", "outputs"))
        cases += cli_custom["cases"]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            with Phase(16, "transfer trainer CLI"):
                cli_transfer = phase_transfer_cli(Path(tmp), frame)
            shutil.copytree(Path(tmp) / "models" /
                            "maskrcnn_resnet50_two_stage.ckpt",
                            ckpts["transfer"])
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            with Phase(17, "serve front ends"):
                fronts = phase_serve_fronts(Path(tmp), ckpts, smi)
        cases += fronts["cases"]
        torch.cuda.empty_cache()

        # 18. the mesh: FLOPs and MFU, world size 1 over NCCL, two ranks
        # on the card over gloo.
        with Phase(18, "mesh"):
            flops18 = phase_mesh_flops(cfg, tcfg, frame, smi)
            phase_mesh_nccl(cfg, tcfg, frame)
            phase_mesh_gloo(cfg)

        # 19. the quality tools, from a directory removed when the phase
        # ends, on phase 15's checkpoint and split.
        with tempfile.TemporaryDirectory() as tmp:
            with Phase(19, "quality tools"):
                quality = phase_quality_tools(Path(tmp), ckpts["custom"],
                                              str(sparse), cli_custom)
        cases += quality["cases"]
        torch.cuda.empty_cache()

    # 20. the measurement tools, from a directory removed when the phase
    # ends.
    with tempfile.TemporaryDirectory() as tmp:
        with Phase(20, "measure tools"):
            measure = phase_measure_tools(Path(tmp), flops18, smi)
    cases += measure["cases"]
    torch.cuda.empty_cache()

    # 21. the real-data runbook, its children on the card, from a
    # directory removed when the phase ends.
    with tempfile.TemporaryDirectory() as tmp:
        with Phase(21, "runbook"):
            runbook_res = phase_runbook(Path(tmp), smi)

    # 22. the JAX package's checkpoints: read, served, resumed.
    with tempfile.TemporaryDirectory() as tmp:
        with Phase(22, "jax ckpt"):
            jax_res = phase_jax_ckpt(Path(tmp), frame, smi)
    cases += jax_res["cases"]

    # The kernels' line: every kernel's headline case at its training
    # step's shape (K1-K3: B = 32, K = 128 bf16; K4: T2's full form; K5,
    # K6: T3's B = 4, K = 512 at 7x7, bf16), `launches` from the timed
    # steps of the training path that runs it (T2; T3 for K5, K6); the
    # launches of every path and every case under "cases".
    replaces = {
        "roi_weights": "livecell_tpu/ops/pallas_roi_align.py:90",
        "roi_align_fwd": "livecell_tpu/ops/pallas_roi_align.py:126",
        "roi_align_bwd": "livecell_tpu/ops/pallas_roi_align.py:152",
        "match_anchors": "livecell_tpu/ops/pallas_match.py:44",
        "ms_roi_align_fwd": "livecell_tpu/ops/pallas_ms_roi.py:57",
        "ms_roi_align_bwd": "livecell_tpu/ops/pallas_ms_roi.py:71"}
    sources = {"match_anchors": "match.cu", "ms_roi_align_fwd":
               "ms_roi_align.cu", "ms_roi_align_bwd": "ms_roi_align.cu"}
    heads = {"match_anchors": {"B": 32, "I": 128, "full": True},
             "ms_roi_align_fwd": {"B": T_BATCH, "K": 512, "s": 7,
                                  "dtype": str(torch.bfloat16)},
             "ms_roi_align_bwd": {"B": T_BATCH, "K": 512, "s": 7,
                                  "dtype": str(torch.bfloat16)}}
    train["T3"] = t3
    serve_reqs = (req_a, req_b, req_c, req_d)
    kernels = []
    for kname in replaces:
        mine = [c for c in cases if c["name"] == kname]
        sh = heads.get(kname, {"B": 32, "K": 128,
                               "dtype": str(torch.bfloat16)})
        head = next(c for c in mine
                    if all(c["shape"].get(k) == v for k, v in sh.items()))
        per_path = {label: r["launches_per_step"][kname]
                    for label, r in train.items()
                    if kname in r["launches_per_step"]}
        per_path.update({r["request"][0]: r["launches"][kname]
                         for r in serve_reqs if kname in r["launches"]})
        per_path.update({f"eval {m} per batch": evals[m][
            "launches_per_batch"][kname] for m in ("custom", "transfer")
            if kname in evals[m]["launches_per_batch"]})
        for m, r in (("custom", cli_custom), ("transfer", cli_transfer)):
            if kname in r["launches_per_step"]:
                per_path[f"{m} CLI per step"] = r["launches_per_step"][kname]
                per_path[f"{m} CLI test sweep per batch"] = r[
                    "launches_per_test_batch"][kname]
        if kname in fronts["launches_per_frame"]:
            per_path["visualize custom frame" if kname.startswith("roi_")
                     else "visualize transfer frame"] = fronts[
                "launches_per_frame"][kname]
        if kname in fronts["explain"]["launches_per_tile"]:
            per_path["explain tile"] = fronts["explain"][
                "launches_per_tile"][kname]
        for tool in ("eval", "oracle"):
            if kname in quality[f"launches_per_{tool}_batch"]:
                per_path[f"{tool} tool batch"] = quality[
                    f"launches_per_{tool}_batch"][kname]
        for tool, r in (("profile_step", measure["profile_step"]),
                        ("profile_transfer",
                         measure["profile_transfer"]["scan"])):
            if kname in r["launches_per_step"]:
                per_path[f"{tool} step"] = r["launches_per_step"][kname]
        per_path.update({path: r[kname] for path, r in
                         measure["launches_per_call"].items()
                         if r.get(kname)})
        for run, counts in runbook_res["launches"].items():
            per_path.update({f"runbook {run} run, {stage} child (total)": n
                             for stage, n in ((st, c[kname])
                                              for st, c in counts.items())
                             if n})
        for name, w in runbook_res["witness"].items():
            for tool in ("eval", "oracle"):
                n = w[f"launches_per_{tool}_batch"].get(kname)
                if n:
                    per_path[f"runbook {name} {tool} batch"] = n
        for label, r in (("jax ckpt custom tile",
                          jax_res["custom"]["served"]),
                         ("jax ckpt transfer tile",
                          jax_res["transfer"]["served"]),
                         ("jax ckpt transfer frame",
                          jax_res["transfer"]["frame"])):
            if r["launches"].get(kname):
                per_path[label] = r["launches"][kname]
        if kname in jax_res["resume"]["launches_per_step"]:
            per_path["jax ckpt resume per step"] = jax_res["resume"][
                "launches_per_step"][kname]
        path = "T3" if kname.startswith("ms_") else "T2"
        kernels.append(dict(
            name=kname, route="cuda",
            source="livecell_tpu_torch/csrc/" + sources.get(
                kname, "roi_align.cu"),
            replaces=replaces[kname],
            launches=round(train[path]["launches_per_step"][kname]
                           * TIMED_STEPS),
            launches_per_path=per_path,
            max_abs_err=max(c["max_err"] for c in mine),
            max_err=max(c["max_err"] for c in mine),
            tol=head["tol"], shape=head["shape"], ms=head["ms"],
            kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_us=head["bound_ms"] * 1e3,
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            **({"blocks_per_sm": head["blocks_per_sm"]}
               if "blocks_per_sm" in head else {}),
            cases=mine))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
