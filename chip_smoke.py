#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (livecell_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device is required; prints nvidia-smi's name and
     power limit;
  2. build: builds every kernel from livecell_tpu_torch/csrc with nvcc;
  3. kernels: K1 (roi_weights) and K2 (roi_align_fwd) against their
     plain PyTorch versions on the card at the serving shapes
     (25 tiles, 56x76x256 map, K in {50, 256}, bf16 and f32), each
     within its stated tolerance, timed with CUDA events; K2's library
     yardstick (one three-operand torch.einsum) checked and timed too;
  4. serve: the full-width model (ResNet-18/CBAM/FPN-256 at 224x304,
     bf16, random weights from a seed) serves three requests through
     InferenceEngine.predict: (a) a 704x520 frame with the reference
     defaults, (b) a 300x222 tile, (c) a frame with decode_proposals
     and --dets 256 --infer_nms 0.7 --det_nms 0.6. The launch counters
     must show K1 and K2 ran once per forward (twice in (c));
  5. end to end: request (a)'s forward in f32 with roi_backend="kernel"
     and "plain", same weights, must agree (valid equal; boxes, scores
     and mask probabilities within 1e-3).

Prints the kernels' JSON line, then as the last line
{"ok": true, "device": {...}}. Writes nothing outside the checkout
except the kernels' build directory inside the package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
B, H, W, C = 25, 56, 76, 256     # a frame's tiles, stride-4 map of 224x304
OUT, RATIO, SCALE = 7, 2, 0.25
TOL_K1 = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-6}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, runs=21, calls=10) -> float:
    """Time per call by CUDA events: the median over `runs` runs, each of
    `calls` back-to-back calls (so the host's enqueue overlaps the
    device's work), divided by `calls`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(runs):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs) / calls


def kernel_ms(fn, kernel: str, calls=10) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`, from torch.profiler (excludes the host's launch gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    if not rows:
        raise AssertionError(f"profiler saw no {kernel}")
    return sum(ev.self_device_time_total for ev in rows) / 1e3 / sum(
        ev.count for ev in rows)


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


def phase_kernels(cra) -> list:
    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    feat32 = torch.randn((B, H, W, C), generator=gen).to(dev)
    cases = []
    for k in (50, 256):
        boxes = make_boxes(k, gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            name = f"K={k} {str(dtype).split('.')[-1]}"
            feat = feat32.to(dtype)
            esz = feat.element_size()
            # K1.
            wy, wx = cra.roi_weights(boxes, (H, W), OUT, RATIO, SCALE, dtype)
            py, px = cra.roi_weights_plain(boxes, (H, W), OUT, RATIO, SCALE,
                                           dtype)
            err1 = max((wy.float() - py.float()).abs().max().item(),
                       (wx.float() - px.float()).abs().max().item())
            # K2, on the kernel's own weights.
            out = cra.roi_align_fwd(feat, wy, wx)
            ref = cra.roi_align_fwd_plain(feat, wy, wx)
            diff = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # bf16: the row result and the output are rounded to bf16 in
            # both, after f32 sums taken in another order, which can flip
            # a rounding: 2 bf16 ulps at the output's magnitude. f32:
            # reassociation of <= 16 taps, 1e-5 relative.
            tol2 = (2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
                * max(scale, 1.0)
            torch.cuda.synchronize()
            log(f"[kernels] {name}: K1 max_err {err1:.3g} (tol "
                f"{TOL_K1[dtype]:.3g}), K2 max_err {diff:.3g} (tol "
                f"{tol2:.3g})")
            if not (err1 <= TOL_K1[dtype] and diff <= tol2):
                raise AssertionError(f"kernel disagrees with plain at {name}")
            # The library call rounds at other points (bf16 products or
            # bf16 row sums, then the output): each side is off by at most
            # ~2 bf16 half-ulps of the map's magnitude, so 2^-6 of max|F|
            # in bf16; f32 sums in another order, 1e-5 of max|F|.
            lib = k2_library(feat, wy, wx)
            fmax = feat.float().abs().max().item()
            err_lib = (lib.float() - ref.float()).abs().max().item()
            tol_lib = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * fmax
            torch.cuda.synchronize()
            log(f"[kernels] {name}: library einsum vs plain K2 max_err "
                f"{err_lib:.3g} (tol {tol_lib:.3g})")
            if not err_lib <= tol_lib:
                raise AssertionError(f"library K2 disagrees with plain at "
                                     f"{name}")
            del lib

            k1_bytes = boxes.numel() * 4 + (wy.numel() + wx.numel()) * esz
            k1_ops = 12.0 * RATIO * (wy.numel() + wx.numel())
            k2_bytes = (feat.numel() + wy.numel() + wx.numel()
                        + out.numel()) * esz
            k2_ops = k2_operations(wy, wx, C)
            shape = dict(B=B, H=H, W=W, C=C, K=k, dtype=str(dtype))
            for kname, fn, plain, library, nbytes, ops, err, tol in (
                ("roi_weights",
                 lambda: cra.roi_weights(boxes, (H, W), OUT, RATIO, SCALE,
                                         dtype),
                 lambda: cra.roi_weights_plain(boxes, (H, W), OUT, RATIO,
                                               SCALE, dtype),
                 None, k1_bytes, k1_ops, err1, TOL_K1[dtype]),
                ("roi_align_fwd", lambda: cra.roi_align_fwd(feat, wy, wx),
                 lambda: cra.roi_align_fwd_plain(feat, wy, wx),
                 lambda: k2_library(feat, wy, wx),
                 k2_bytes, k2_ops, diff, tol2),
            ):
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / F32_FLOP_PER_S * 1e3
                cases.append(dict(
                    name=kname, shape=shape, max_err=err, tol=tol,
                    ms=time_ms(fn), plain_ms=time_ms(plain),
                    library_ms=time_ms(library) if library else None,
                    library_err=err_lib if library else None,
                    library_tol=tol_lib if library else None,
                    kernel_ms=kernel_ms(fn, kname + "_kernel"),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, operations=ops))
            del out, ref, wy, wx, py, px
            torch.cuda.empty_cache()
    return cases


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


def profile_request(engine, image) -> dict:
    """Device time by kernel over one steady request (torch.profiler):
    the kernels' summed time, the request's wall time and the share of
    it the device sat idle, and the kernels that took the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(image, score_threshold=0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall),
                kernel_launches=sum(r[2] for r in rows),
                top=[dict(name=k[:70], device_ms=us / 1e3, calls=n)
                     for us, k, n in rows[:10]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from livecell_tpu_torch.config import ModelConfig, TileConfig
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.ops import _build
    from livecell_tpu_torch.ops import cuda_roi_align as cra
    from livecell_tpu_torch.serve.app import InferenceEngine
    from livecell_tpu_torch.serve.stitch import tile_position

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
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    cases = phase_kernels(cra)

    # 4. serve
    tcfg = TileConfig()
    cfg = ModelConfig()
    model = create_model(cfg, torch.Generator().manual_seed(SEED))
    frame = synthetic_frame(tcfg.frame_height, tcfg.frame_width, SEED)
    tile = frame[:tcfg.tile_height, :tcfg.tile_width]
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

    # The kernels' line: headline numbers at the main path's shape
    # (K = 50, bf16); every case under "cases".
    replaces = {
        "roi_weights": "livecell_tpu/ops/pallas_roi_align.py:90",
        "roi_align_fwd": "livecell_tpu/ops/pallas_roi_align.py:126"}
    kernels = []
    for kname in ("roi_weights", "roi_align_fwd"):
        mine = [c for c in cases if c["name"] == kname]
        head = next(c for c in mine if c["shape"]["K"] == 50
                    and "bfloat16" in c["shape"]["dtype"])
        kernels.append(dict(
            name=kname, route="cuda",
            source="livecell_tpu_torch/csrc/roi_align.cu",
            replaces=replaces[kname], launches=req_a["launches"][kname],
            launches_per_request={r["request"][0]: r["launches"][kname]
                                  for r in (req_a, req_b, req_c)},
            max_abs_err=max(c["max_err"] for c in mine),
            max_err=max(c["max_err"] for c in mine),
            tol=head["tol"], shape=head["shape"], ms=head["ms"],
            kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_us=head["bound_ms"] * 1e3,
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            cases=mine))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
