"""Full-frame tiled inference with overlap-dedup stitching (counterpart
of livecell_tpu/serve/stitch.py: TILE_RE, group_tiles_by_image,
tile_position, claimed_regions, make_frame_predictor,
reconstruct_full_image, load_tiles).

All tiles of a frame go through one batched forward. The dedup rule is
precomputed into static per-tile "newly claimed mini-tile" masks:

  * tile t owns its center mini-tile plus any grid-border mini-tiles of
    its 3x3 window; tiles claim in ascending order, first claim wins;
  * a detection is kept iff the fraction of its mask area inside its
    tile's claimed region exceeds mask_threshold.
"""

from __future__ import annotations

import itertools
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from livecell_tpu_torch.config import TileConfig, TransferConfig
from livecell_tpu_torch.data.png import read_png
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.ops.proposals import top_k_stable
from livecell_tpu_torch.utils.profiling import span

TILE_RE = re.compile(r"^(.+)_tile_(\d{2})\.png$")


def group_tiles_by_image(test_dir: str) -> Dict[str, List[Dict]]:
    """Tile files of a directory grouped by source frame, each group in
    tile order: {frame: [{"path", "tile_num", "filename"}, ...]}."""
    groups: Dict[str, List[Dict]] = defaultdict(list)
    if not os.path.isdir(test_dir):
        print(f"Error: test directory {test_dir} does not exist.")
        return {}
    for filename in sorted(os.listdir(test_dir)):
        m = TILE_RE.match(filename)
        if m:
            groups[m.group(1)].append({
                "path": os.path.join(test_dir, filename),
                "tile_num": int(m.group(2)),
                "filename": filename,
            })
    return {k: sorted(v, key=lambda x: x["tile_num"])
            for k, v in groups.items()}


def tile_position(tile_num: int, tiles_per_row: int) -> tuple[int, int]:
    """(col_start, row_start) in mini-tile units."""
    return tile_num % tiles_per_row, tile_num // tiles_per_row


def claimed_regions(cfg: TileConfig) -> np.ndarray:
    """float32 [num_tiles, tile_h, tile_w]: 1 where a pixel of tile t
    (tile-local coordinates) lies in a mini-tile that t claims first."""
    g, w = cfg.grid_size, cfg.window_size
    mini_w, mini_h = cfg.mini_tile_width, cfg.mini_tile_height
    tpr = cfg.tiles_per_row

    processed = set()
    regions = np.zeros((cfg.num_tiles, cfg.tile_height, cfg.tile_width),
                       np.float32)
    for t in range(cfg.num_tiles):
        col0, row0 = tile_position(t, tpr)
        for lr in range(w):
            for lc in range(w):
                mc, mr = col0 + lc, row0 + lr
                is_center = (lc == 1 and lr == 1)
                is_border = (mc == 0 or mc == g - 1 or mr == 0 or
                             mr == g - 1)
                if not (is_center or is_border) or (mc, mr) in processed:
                    continue
                processed.add((mc, mr))
                y0, x0 = lr * mini_h, lc * mini_w
                regions[t, y0:y0 + mini_h, x0:x0 + mini_w] = 1.0
    return regions


class StitchedDetections(NamedTuple):
    boxes: np.ndarray      # [N, 4] global frame coords
    scores: np.ndarray     # [N]
    masks: np.ndarray      # [N, tile_h, tile_w] bool, tile-local
    offsets: np.ndarray    # [N, 2] (x_offset, y_offset) of the source tile
    tile_nums: np.ndarray  # [N]


def input_tile(mcfg) -> tuple[int, int]:
    """(height, width) of the model's input tile, which a frame's tiles
    are zero-padded to: the custom model's image_height x image_width,
    the transfer model's tile_height x tile_width (it resizes the tile to
    its canvas itself)."""
    if isinstance(mcfg, TransferConfig):
        return mcfg.tile_height, mcfg.tile_width
    return mcfg.image_height, mcfg.image_width


def make_frame_predictor(model, tile_cfg: TileConfig,
                         score_threshold: float = 0.5,
                         mask_threshold: float = 0.4,
                         max_frame_dets: int = 256, device=None, mesh=None):
    """Build the frame predictor for `model` (a CustomMaskRCNN or a
    TransferMaskRCNN already on `device`, the card unless the caller
    passes "cpu"). Each tile is zero-padded to the model's input tile
    (`input_tile`) and its masks are pasted on that grid.

    Returns run(tiles_u8 [T, th, tw, 3] numpy) -> StitchedDetections,
    with run.dispatch (enqueue a frame, returns a handle without
    waiting), run.fetch (wait and unpack), run.device_fn (the device
    computation on a uint8 tile tensor), run.n_pad_tiles and run.stats:
    the frames fetched and the host seconds spent in `dispatch`
    (dispatch_s), blocked in `fetch` until the card is done (wait_s)
    and copying back and unpacking (unpack_s), counted always.

    With `mesh` (parallel/mesh.py; the model replicated on every rank)
    the frame's tiles are split over the data axis, padded to a multiple
    of it with zero claim regions, so pad tiles keep nothing: each rank
    detects on its share, the fixed-slot candidates (boxes, scores, keep
    flags) are gathered over the data axis, every rank picks the same
    survivors, and each survivor's packed mask is summed in from the one
    rank that holds it. Every rank returns the same StitchedDetections.
    """
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model is on {param_dev}, predictor on {dev}")
    mcfg = model.cfg
    ih, iw = input_tile(mcfg)
    th, tw = tile_cfg.tile_height, tile_cfg.tile_width
    tpr = tile_cfg.tiles_per_row
    t_idx = np.arange(tile_cfg.num_tiles)
    offs = np.stack([(t_idx % tpr) * tile_cfg.mini_tile_width,
                     (t_idx // tpr) * tile_cfg.mini_tile_height],
                    axis=1).astype(np.float32)          # [T, 2] (x, y)
    regions = claimed_regions(tile_cfg)
    n_tiles = tile_cfg.num_tiles
    if mesh is not None:
        n_tiles = -(-n_tiles // mesh.data_size) * mesh.data_size
        regions = np.concatenate([regions, np.zeros(
            (n_tiles - len(regions), th, tw), np.float32)])
    regions = torch.from_numpy(regions).to(dev) > 0
    rows = mesh.rows(n_tiles) if mesh is not None else slice(None)
    tw_pad = ((tw + 7) // 8) * 8
    max_frame_dets = min(max_frame_dets, n_tiles * mcfg.max_detections)
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=dev)

    @torch.inference_mode()
    def predict(tiles_u8: torch.Tensor):
        with span("livecell.stage_in"):
            images = tiles_u8[rows].float() / 255.0
            images = F.pad(images, (0, 0, 0, iw - tw, 0, ih - th))
        det = model.inference_forward(images)

        with span("livecell.stitch"):
            masks = paste_masks(det.mask_probs, det.boxes, (ih, iw),
                                valid=det.valid)[:, :, :th, :tw] > 0
            area = masks.sum(dim=(2, 3)).float()            # [T, D]
            inside = (masks & regions[rows, None]).sum(dim=(2, 3)).float()
            frac = torch.where(area > 0, inside / area.clamp(min=1.0),
                               torch.zeros_like(area))
            keep = det.valid & (det.scores > score_threshold) & \
                (frac > mask_threshold)
            boxes, scores = det.boxes, det.scores
            if mesh is not None:
                keep, boxes, scores = (mesh.data.gather(t)
                                       for t in (keep, boxes, scores))

            # Global compaction to max_frame_dets slots + bit-packed
            # masks (8 px per byte), so little crosses back to the host.
            t_total, d = keep.shape
            pri = torch.where(keep, scores + 1.0,
                              torch.zeros_like(scores)).reshape(-1)
            top, idx = top_k_stable(pri, max_frame_dets)
            flat = masks.reshape(-1, th, tw)
            if mesh is None:
                sel_masks = flat[idx]
            else:
                # The slots this rank's tiles hold; the others stay zero.
                local = idx - rows.start * d
                own = (local >= 0) & (local < flat.shape[0])
                sel_masks = flat[local.clamp(0, flat.shape[0] - 1)] \
                    & own[:, None, None]
            packed = (F.pad(sel_masks, (0, tw_pad - tw))
                      .reshape(max_frame_dets, th, tw_pad // 8, 8)
                      .to(torch.uint8) * bits).sum(dim=-1).to(torch.uint8)
            if mesh is not None:
                dist.all_reduce(packed, group=mesh.data.group)
            return (boxes.reshape(-1, 4)[idx], scores.reshape(-1)[idx],
                    packed, idx, top > 0.5)

    # A copy from pageable host memory waits for the card to finish the
    # work already queued (the previous frame), so dispatch could not
    # overlap it. The tiles go through pinned staging buffers instead,
    # copied without blocking: one per frame in flight (run_pipelined
    # keeps two), each reused only once the event after its copy has
    # passed.
    staging: List[tuple] = []

    def to_device(tiles_u8: np.ndarray) -> torch.Tensor:
        if dev.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(tiles_u8))
        if not staging:
            staging.extend((torch.empty((n_tiles, th, tw, 3),
                                        dtype=torch.uint8).pin_memory(),
                            torch.cuda.Event()) for _ in range(2))
        buf, copied = staging.pop(0)
        copied.synchronize()
        buf.numpy()[...] = tiles_u8
        out = torch.empty(buf.shape, dtype=torch.uint8, device=dev)
        out.copy_(buf, non_blocking=True)
        copied.record()
        staging.append((buf, copied))
        return out

    requests = itertools.count()
    stats = {"frames": 0, "dispatch_s": 0.0, "wait_s": 0.0,
             "unpack_s": 0.0}

    def dispatch(tiles_u8: np.ndarray):
        """Enqueue one frame; returns a handle of device tensors without
        waiting. The span livecell.frame opens here and closes in
        `fetch`."""
        t0 = time.perf_counter()
        frame = span("livecell.frame", next(requests))
        frame.__enter__()
        try:
            with span("livecell.stage_in"):
                if len(tiles_u8) < n_tiles:
                    tiles_u8 = np.concatenate(
                        [tiles_u8, np.zeros(
                            (n_tiles - len(tiles_u8), th, tw, 3), np.uint8)])
                x = to_device(tiles_u8)
            out = predict(x)
        except BaseException:
            frame.__exit__(None, None, None)
            raise
        stats["dispatch_s"] += time.perf_counter() - t0
        return out, frame

    def fetch(handle) -> StitchedDetections:
        """Wait for a dispatch() handle and unpack to host detections.
        The copy of its first tensor (the boxes, 4 KB) waits for the
        card to finish the frame (the span livecell.wait); the other
        copies and the unpacking follow (livecell.unpack)."""
        out, frame = handle
        t0 = time.perf_counter()
        try:
            with span("livecell.wait"):
                boxes = out[0].cpu().numpy()
            t1 = time.perf_counter()
            with span("livecell.unpack"):
                scores, packed, idx, sel_valid = (
                    t.cpu().numpy() for t in out[1:])
                masks = np.unpackbits(packed[sel_valid], axis=-1)[
                    :, :, :tw].astype(bool)
                # idx is flat over [T, D], D the detection slot count.
                t_ids = idx[sel_valid] // mcfg.max_detections
                sel_off = offs[t_ids]
        finally:
            frame.__exit__(None, None, None)
        stats["frames"] += 1
        stats["wait_s"] += t1 - t0
        stats["unpack_s"] += time.perf_counter() - t1
        return StitchedDetections(
            boxes=boxes[sel_valid] + np.concatenate([sel_off, sel_off],
                                                    axis=1),
            scores=scores[sel_valid], masks=masks, offsets=sel_off,
            tile_nums=t_ids)

    def run(tiles_u8: np.ndarray) -> StitchedDetections:
        return fetch(dispatch(tiles_u8))

    run.device_fn = predict
    run.n_pad_tiles = n_tiles
    run.dispatch = dispatch
    run.fetch = fetch
    run.stats = stats
    return run


def reconstruct_full_image(tiles_u8: np.ndarray, cfg: TileConfig
                           ) -> np.ndarray:
    """Paste tiles back into the frame, first cover wins. Returns float32
    [H, W, 3] in [0, 1]; pixels no tile covers stay 0."""
    canvas = np.zeros((cfg.frame_height, cfg.frame_width, 3), np.float32)
    covered = np.zeros((cfg.frame_height, cfg.frame_width), bool)
    for t in range(len(tiles_u8)):
        col0, row0 = tile_position(t, cfg.tiles_per_row)
        x0, y0 = col0 * cfg.mini_tile_width, row0 * cfg.mini_tile_height
        h, w = tiles_u8[t].shape[:2]
        y1, x1 = min(y0 + h, cfg.frame_height), min(x0 + w, cfg.frame_width)
        patch = tiles_u8[t][:y1 - y0, :x1 - x0].astype(np.float32) / 255.0
        un = ~covered[y0:y1, x0:x1]
        canvas[y0:y1, x0:x1][un] = patch[un]
        covered[y0:y1, x0:x1] = True
    return canvas


def load_tiles(tiles_info: List[Dict], cfg: TileConfig) -> np.ndarray:
    """Read one frame's tile PNGs (data/png.py's decoder, grey widened to
    RGB) into uint8 [T, th, tw, 3]; missing tiles are zero-filled."""
    out = np.zeros((cfg.num_tiles, cfg.tile_height, cfg.tile_width, 3),
                   np.uint8)
    for info in tiles_info:
        arr = read_png(info["path"])
        t = info["tile_num"]
        h = min(arr.shape[0], cfg.tile_height)
        w = min(arr.shape[1], cfg.tile_width)
        out[t, :h, :w] = arr[:h, :w]
    return out
