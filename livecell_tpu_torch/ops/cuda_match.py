"""Anchor-GT matching through the hand-written Hopper kernel of
csrc/match.cu (counterpart of livecell_tpu/ops/pallas_match.py).

K4 `match_anchors` anchors [N,4], gt_boxes [B,I,4], gt_valid [B,I] ->
   max_iou [B,N] (invalid GT count as IoU -1); with `full` also the
   planar regression targets [B,4,N] of each anchor's first best GT and
   each GT's first best anchor [B,I] (replaces `_kernel`).

As for every kernel of the port: a launch counter
(`match_anchors.launches`, raised by one per wrapper call that launches
the kernel and, with `full` or several GT chunks, its finalize pass), a
plain PyTorch version (`match_anchors_plain`, the counterpart of
`match_anchors_xla`), and a wrapper that computes the plain version on
CPU tensors and launches the kernel, or raises, on CUDA tensors.
`match_anchors_emulated` replays the kernel's decomposition (valid GT
only, GT chunks, packed keys merged by maxima) on the CPU for the tests;
nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from livecell_tpu_torch.ops import _build
from livecell_tpu_torch.ops.boxes import box_area, box_iou, encode_boxes
from livecell_tpu_torch.ops.cuda_roi_align import _require_cuda, _stream
from livecell_tpu_torch.ops.proposals import take_rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("match")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.livecell_match_anchors.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           p]
    lib.livecell_match_anchors.restype = i
    lib.livecell_match_chunks.argtypes = [i, i, i]
    lib.livecell_match_chunks.restype = i
    lib.livecell_match_scratch_bytes.argtypes = [i, i, i, i]
    lib.livecell_match_scratch_bytes.restype = ctypes.c_longlong
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


def match_kernels(b: int, n: int, n_gt: int, full: bool) -> tuple:
    """Names of the CUDA kernels one `match_anchors` call launches at
    these shapes: the matcher, and its finalize pass with `full` or when
    the C entry splits the GT axis into chunks (one image)."""
    chunks = _lib().livecell_match_chunks(b, n, n_gt)
    return ("match_kernel",) + (
        ("match_finalize_kernel",) if full or chunks > 1 else ())


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
    # The merge keys of a call whose GT axis is split into chunks.
    nbytes = _lib().livecell_match_scratch_bytes(b, n, n_gt, int(full))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) \
        if nbytes else None
    code = _lib().livecell_match_anchors(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(),
        max_iou.data_ptr(), tgt.data_ptr() if full else None,
        best.data_ptr() if full else None,
        scratch.data_ptr() if nbytes else None, b, n, n_gt, int(full),
        _stream(dev))
    if code != 0:
        msg = _lib().livecell_match_error_string(code).decode()
        raise RuntimeError(f"match_anchors: CUDA error {code} ({msg})")
    match_anchors.launches += 1
    return (max_iou, tgt, best) if full else max_iou


match_anchors.launches = 0


# ---------------------------------------------------------------------------
# The kernel's decomposition, replayed on the CPU (tests only).
# ---------------------------------------------------------------------------

# csrc/match.cu: a block of THREADS threads holds PER_THREAD anchors a
# thread, THREADS apart; warps of WARP lanes.
THREADS, PER_THREAD, WARP = 128, 4, 32
_LOW = np.uint64(0xffffffff)


def order_bits(v: np.ndarray) -> np.ndarray:
    """csrc/match.cu:order_bits: float32 -> uint32, monotone (a larger
    float, a larger key; -0 below +0)."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return np.where(b & np.uint32(0x80000000), ~b,
                    b | np.uint32(0x80000000)).astype(np.uint32)


def pack_key(bits: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit key: order bits above the index's complement,
    so the larger IoU wins and, among equal IoU, the lower index."""
    return (bits.astype(np.uint64) << np.uint64(32)) \
        | (_LOW - index.astype(np.uint64))


def match_anchors_emulated(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                           gt_valid: torch.Tensor, full: bool = True,
                           chunk: int = None):
    """Plain emulation of csrc/match.cu's decomposition, for the tests:
    the GT slots in chunks of `chunk` (default all), each chunk's valid
    GT only, an anchor's chunk max from +0 over the pairs with a positive
    intersection (the others are IoU +0 and skipped), merged across
    chunks as packed keys with the image's first valid slot; (full) each
    GT's best anchor as the kernel's warps report it (a thread's first
    anchor at its max, then the warp's, only for warps with a positive
    IoU), merged as packed keys, key 0 meaning anchor 0. Returns what
    `match_anchors_plain` returns, from the same IoU arithmetic."""
    a, g = anchors.float(), gt_boxes.float()
    b, n_gt = gt_valid.shape
    n = a.shape[0]
    chunk = n_gt if chunk is None else chunk
    # box_iou's arithmetic, the division only where the intersection is
    # positive.
    lt = torch.maximum(a[:, None, :2], g[:, None, :, :2])
    rb = torch.minimum(a[:, None, 2:], g[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]                          # [B, N, I]
    union = box_area(a)[:, None] + box_area(g)[:, None, :] - inter
    pos = inter > 0
    iou = torch.where(pos & (union > 0), inter / union.clamp(min=1e-12),
                      0.0)
    iou = iou.numpy()
    valid = gt_valid.numpy()
    live = valid[:, None, :] & (iou > 0)     # pairs that can raise a max

    # Per anchor: each chunk's max and first slot at it, as a key.
    key = np.zeros((b, n), np.uint64)
    for lo in range(0, n_gt, chunk):
        sub = np.where(live[..., lo:lo + chunk], iou[..., lo:lo + chunk],
                       np.float32(0))
        m = sub.max(-1)
        at = lo + (sub == m[..., None]).argmax(-1)
        key = np.maximum(key, np.where(m > 0, pack_key(order_bits(m), at), 0))
    has = valid.any(-1)[:, None]
    first = valid.argmax(-1)[:, None]        # the image's first valid slot
    hit = key != 0
    max_iou = np.where(hit, (key >> np.uint64(32)).astype(np.uint32)
                       & np.uint32(0x7fffffff), np.uint32(0)).view(np.float32)
    max_iou = np.where(hit, max_iou, np.where(has, np.float32(0),
                                              np.float32(-1)))
    max_iou = torch.from_numpy(max_iou.astype(np.float32))
    if not full:
        return max_iou
    slot = np.where(hit, _LOW - (key & _LOW), np.where(has, first, 0))
    matched = take_rows(g, torch.from_numpy(slot.astype(np.int64)))
    tgt = encode_boxes(matched, a).transpose(1, 2).contiguous()

    # Per GT: the warps' reports. Anchor blk * THREADS * PER_THREAD +
    # s * THREADS + t sits in thread t, its s-th; padded anchors never
    # report.
    per_block = THREADS * PER_THREAD
    n_pad = -(-n // per_block) * per_block
    bits = np.where(live, order_bits(iou), np.uint32(0))
    bits = np.pad(bits, ((0, 0), (0, n_pad - n), (0, 0)))
    idx = np.arange(n_pad, dtype=np.uint32)
    shape = (b, n_pad // per_block, PER_THREAD, THREADS // WARP, WARP, n_gt)
    bits = bits.reshape(shape)
    idx = np.broadcast_to(idx.reshape((1,) + shape[1:5] + (1,)), shape)
    # A thread: its first anchor (s ascending) at its max.
    t_bits = bits.max(2)
    t_idx = np.where(bits == t_bits[:, :, None], idx,
                     np.uint32(0xffffffff)).min(2)
    # A warp with a positive pair: the max, then its lowest anchor.
    w_bits = t_bits.max(3)
    w_idx = np.where(t_bits == w_bits[:, :, :, None], t_idx,
                     np.uint32(0xffffffff)).min(3)
    gkey = np.where(w_bits != 0, pack_key(w_bits, w_idx), 0).max((1, 2))
    best = np.where(gkey != 0, _LOW - (gkey & _LOW), 0).astype(np.int64)
    return max_iou, tgt, torch.from_numpy(best)
