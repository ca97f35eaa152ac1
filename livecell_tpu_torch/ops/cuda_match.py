"""Anchor-GT matching through the hand-written Hopper kernel of
csrc/match.cu (counterpart of livecell_tpu/ops/pallas_match.py).

K4 `match_anchors` anchors [N,4], gt_boxes [B,I,4], gt_valid [B,I] ->
   max_iou [B,N] (invalid GT count as IoU -1); with `full` also the
   planar regression targets [B,4,N] of each anchor's first best GT and
   each GT's first best anchor [B,I] (replaces `_kernel`).

As for every kernel of the port: a launch counter
(`match_anchors.launches`, raised by one per kernel launch), a plain
PyTorch version (`match_anchors_plain`, the counterpart of
`match_anchors_xla`), and a wrapper that computes the plain version on
CPU tensors and launches the kernel, or raises, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from livecell_tpu_torch.ops import _build
from livecell_tpu_torch.ops.boxes import box_iou, encode_boxes
from livecell_tpu_torch.ops.cuda_roi_align import _require_cuda, _stream
from livecell_tpu_torch.ops.proposals import take_rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("match")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.livecell_match_anchors.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.livecell_match_anchors.restype = i
    lib.livecell_match_error_string.argtypes = [i]
    lib.livecell_match_error_string.restype = ctypes.c_char_p
    return lib


def match_anchors_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_valid: torch.Tensor, full: bool = True):
    """Plain version of K4 (`match_anchors_xla`): the [B, N, I] IoU
    matrix with invalid GT set to -1, its maxima and first-index
    argmaxes (torch.argmax, like jnp.argmax, returns the first)."""
    ious = box_iou(anchors.float(), gt_boxes.float())          # [B, N, I]
    ious = torch.where(gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    max_iou = ious.amax(dim=-1)
    if not full:
        return max_iou
    matched = take_rows(gt_boxes.float(), ious.argmax(dim=-1))  # [B, N, 4]
    tgt = encode_boxes(matched, anchors.float()).transpose(1, 2)
    return max_iou, tgt.contiguous(), ious.argmax(dim=-2)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, full: bool = True):
    """K4 wrapper: anchors [N,4] f32, gt_boxes [B,I,4] f32, gt_valid
    [B,I] bool -> max_iou [B,N] f32, and with `full` also (targets
    [B,4,N] f32, best_anchor [B,I] int64)."""
    if anchors.device.type == "cpu":
        return match_anchors_plain(anchors, gt_boxes, gt_valid, full)
    dev = _require_cuda(anchors, gt_boxes, gt_valid)
    b, n_gt = gt_valid.shape
    n = anchors.shape[0]
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32 \
            or gt_valid.dtype != torch.bool:
        raise ValueError(f"match_anchors kernel takes f32 anchors and GT "
                         f"boxes and bool validity, got {anchors.dtype}, "
                         f"{gt_boxes.dtype}, {gt_valid.dtype}")
    if tuple(anchors.shape) != (n, 4) or tuple(gt_boxes.shape) != \
            (b, n_gt, 4) or n_gt == 0 or b * n_gt >= 2 ** 31:
        raise ValueError(f"match_anchors kernel takes anchors [N,4], GT "
                         f"[B,I>0,4] and valid [B,I], got "
                         f"{tuple(anchors.shape)}, {tuple(gt_boxes.shape)}, "
                         f"{tuple(gt_valid.shape)}")
    max_iou = torch.empty((b, n), dtype=torch.float32, device=dev)
    tgt = best = None
    if full:
        tgt = torch.empty((b, 4, n), dtype=torch.float32, device=dev)
        best = torch.empty((b, n_gt), dtype=torch.int64, device=dev)
    code = _lib().livecell_match_anchors(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(),
        max_iou.data_ptr(), tgt.data_ptr() if full else None,
        best.data_ptr() if full else None, b, n, n_gt, int(full),
        _stream(dev))
    if code != 0:
        msg = _lib().livecell_match_error_string(code).decode()
        raise RuntimeError(f"match_anchors: CUDA error {code} ({msg})")
    match_anchors.launches += 1
    return (max_iou, tgt, best) if full else max_iou


match_anchors.launches = 0
