"""Overlay renderer for full-frame serve visualizations (counterpart of
livecell_tpu/serve/render.py: TAB20, composite, instance_overlay,
render_panels).

The GT-vs-prediction panel is drawn directly instead of through a
matplotlib figure:

- instance overlays alpha-composited with one vectorized numpy blend
  per panel (no per-instance full-frame temporaries),
- score labels / titles drawn with PIL's bitmap text,
- panels hstacked at NATIVE frame resolution and PNG-encoded once
  (compress_level 1 — these are preview artifacts, not archives).

TAB20, composite and instance_overlay are numpy only; PIL is imported
inside the functions that draw. matplotlib stays available behind
`renderer="mpl"` in serve/visualize.py.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# matplotlib's tab20 qualitative palette (RGB in [0,1]); hardcoded so
# the fast path never imports matplotlib.
TAB20 = np.array([
    (0.1216, 0.4667, 0.7059), (0.6824, 0.7804, 0.9098),
    (1.0000, 0.4980, 0.0549), (1.0000, 0.7333, 0.4706),
    (0.1725, 0.6275, 0.1725), (0.5961, 0.8745, 0.5412),
    (0.8392, 0.1529, 0.1569), (1.0000, 0.5961, 0.5882),
    (0.5804, 0.4039, 0.7412), (0.7725, 0.6902, 0.8353),
    (0.5490, 0.3373, 0.2941), (0.7686, 0.6118, 0.5804),
    (0.8902, 0.4667, 0.7608), (0.9686, 0.7137, 0.8235),
    (0.4980, 0.4980, 0.4980), (0.7804, 0.7804, 0.7804),
    (0.7373, 0.7412, 0.1333), (0.8588, 0.8588, 0.5529),
    (0.0902, 0.7451, 0.8118), (0.6196, 0.8549, 0.8980),
], np.float32)


def composite(base_u8: np.ndarray, overlay_rgba: np.ndarray) -> np.ndarray:
    """Alpha-composite an RGBA float overlay onto a uint8 RGB image."""
    base = base_u8.astype(np.float32)
    if base.ndim == 2:
        base = np.repeat(base[..., None], 3, axis=-1)
    alpha = overlay_rgba[..., 3:4]
    out = base * (1.0 - alpha) + overlay_rgba[..., :3] * 255.0 * alpha
    return out.astype(np.uint8)


def instance_overlay(masks: Sequence[np.ndarray],
                     offsets: Optional[np.ndarray],
                     frame_hw: Tuple[int, int],
                     alpha: float = 0.5) -> np.ndarray:
    """RGBA overlay of boolean instance masks, tab20-colored.

    `masks[i]` is a (mh, mw) bool array pasted at integer offset
    `offsets[i] = (x, y)` (or at (0, 0) full-frame when offsets is
    None). One canvas, written in place — no per-instance (H, W, 4)
    temporaries (the former create_gt_mask_overlay allocated ~6 MB per
    annotation at 704x520; LIVECell frames carry hundreds)."""
    h, w = frame_hw
    canvas = np.zeros((h, w, 4), np.float32)
    for idx, mask in enumerate(masks):
        if mask is None:
            continue
        color = TAB20[idx % 20]
        ox, oy = (0, 0) if offsets is None else (
            int(offsets[idx][0]), int(offsets[idx][1]))
        mh, mw = mask.shape
        y1, x1 = min(oy + mh, h), min(ox + mw, w)
        if y1 <= oy or x1 <= ox:
            continue
        sub = mask[:y1 - oy, :x1 - ox]
        # nonzero + scatter: one full-frame scan per instance instead
        # of two full-frame boolean-indexed writes (2.5x at LIVECell
        # densities — the write set is ~200 cell pixels, not 370k).
        ys, xs = np.nonzero(sub)
        canvas[ys + oy, xs + ox] = (color[0], color[1], color[2], alpha)
    return canvas


def _font(size: int):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: fixed-size bitmap font
        return ImageFont.load_default()


def render_panels(panels: List[Tuple[np.ndarray, str,
                                     List[Tuple[float, float, str]]]],
                  suptitle: str, path: str,
                  title_px: int = 28, label_px: int = 11,
                  pad: int = 4) -> str:
    """Hstack (image_u8, title, labels) panels under a suptitle bar and
    PNG-encode once at native resolution.

    labels are (x, y, text) in image coordinates, drawn centered with
    a dark backing box (the score tags of reference
    visualize.py:427-434)."""
    from PIL import Image, ImageDraw

    h = max(p[0].shape[0] for p in panels)
    widths = [p[0].shape[1] for p in panels]
    top = title_px + 2 * pad          # suptitle bar
    head = title_px + 2 * pad         # per-panel title strip
    total_w = sum(widths) + pad * (len(panels) + 1)
    total_h = top + head + h + 2 * pad
    sheet = Image.new("RGB", (total_w, total_h), (255, 255, 255))
    draw = ImageDraw.Draw(sheet)
    tfont, lfont = _font(title_px - 8), _font(label_px)

    draw.text((total_w // 2, pad + (title_px // 2)), suptitle,
              fill=(0, 0, 0), font=tfont, anchor="mm")
    x = pad
    for (img, title, labels), w in zip(panels, widths):
        draw.text((x + w // 2, top + (title_px // 2)), title,
                  fill=(0, 0, 0), font=tfont, anchor="mm")
        pimg = Image.fromarray(img)
        pdraw = ImageDraw.Draw(pimg)
        for lx, ly, text in labels:
            bbox = pdraw.textbbox((lx, ly), text, font=lfont, anchor="mm")
            pdraw.rectangle((bbox[0] - 1, bbox[1] - 1,
                             bbox[2] + 1, bbox[3] + 1), fill=(0, 0, 0))
            pdraw.text((lx, ly), text, fill=(255, 255, 255), font=lfont,
                       anchor="mm")
        sheet.paste(pimg, (x, top + head))
        x += w + pad

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sheet.save(path, compress_level=1)
    return path
