"""The yardstick's arithmetic: the H100's peaks, the FLOP count of a
step or request, and the work the hand-written kernels' algorithms need.

`FlopCounter` is a copy of the rules of livecell_tpu_torch/utils/flops.py
(itself those of the JAX package), with a rule for fused attention that
it lacks: it runs a call under a
TorchDispatchMode and charges a matrix product 2 * batch * M * N * K, a
convolution 2 * out_elems * fan_in * kspace, its input gradient 2 *
in_elems * out_channels * kspace and its weight gradient as the forward,
a fused scaled-dot-product attention (the flash, efficient, cuDNN and
CPU flash ops F.scaled_dot_product_attention reaches it as) 2 * batch *
heads * Lq * Lk * (D + Dv), the heads the query's, and its backward twice
that, as the same attention written as matrix products is charged (its
bias add and softmax, like every other elementwise op, nothing), and
every other aten op nothing. The kernels run through ctypes, out of
its sight: the benchmark's op wrappers (trace.py) charge each call the
operations of `WORK` below, forward and backward, instead of the dense
charge utils/flops.py gives them.

`WORK[op](args, kwargs)` returns {"fwd": (bytes, ops), "bwd": (bytes,
ops)} for one call of the op, counted from its arguments as the
algorithm needs it: each input byte read once and each output byte
written once, only the feature pixels some ROI's taps read, the taps
each sample needs (one on an integral coordinate, else two), and for the
matcher the valid GT slots alone. The least time of the work is the
larger of bytes over the HBM rate and operations over the f32 rate of
the CUDA cores (the kernels accumulate in f32 outside the tensor
cores)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 data sheet, dense, at its 700 W power limit.
BF16_PEAK = 989.4e12
F32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

aten = torch.ops.aten


def _mm(args, out):
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(args, out):
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv(args, out):
    weight, transposed, groups = args[1], args[6], args[8]
    kin = weight.shape[0] // groups if transposed else weight.shape[1]
    return 2.0 * out.numel() * kin * math.prod(weight.shape[2:])


def _conv_backward(args, out):
    grad_out, inp, weight = args[0], args[1], args[2]
    transposed, groups, mask = args[7], args[9], args[10]
    kspace = math.prod(weight.shape[2:])
    total = 0.0
    if mask[0]:
        kout = weight.shape[1] if transposed else weight.shape[0] // groups
        total += 2.0 * inp.numel() * kout * kspace
    if mask[1]:
        kin = weight.shape[0] // groups if transposed else weight.shape[1]
        total += 2.0 * grad_out.numel() * kin * kspace
    return total


def _sdpa(q, k, v) -> float:
    """2 * batch * heads * Lq * Lk * (D + Dv): the two products of the
    attention, the heads taken from the query (grouped key and value heads
    count as the query's, as torch.utils.flop_counter counts them)."""
    return 2.0 * math.prod(q.shape[:-2]) * q.shape[-2] * k.shape[-2] * (
        q.shape[-1] + v.shape[-1])


RULES = {aten.mm: _mm, aten.addmm: lambda a, o: _mm(a[1:], o),
         aten.bmm: _bmm, aten.baddbmm: lambda a, o: _bmm(a[1:], o),
         aten.convolution: _conv,
         aten.convolution_backward: _conv_backward}
# The fused attention ops that F.scaled_dot_product_attention reaches the
# mode as (those the installed torch has): query, key and value come first
# in a forward, after the output's gradient in a backward, which is
# charged twice the forward.
for _name in ("_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention_for_cpu",
              "_scaled_dot_product_fused_attention_overrideable"):
    if hasattr(aten, _name):
        RULES[getattr(aten, _name)] = lambda a, o: _sdpa(*a[:3])
    if hasattr(aten, _name + "_backward"):
        RULES[getattr(aten, _name + "_backward")] = \
            lambda a, o: 2.0 * _sdpa(*a[1:4])


class FlopCounter(TorchDispatchMode):
    """`total`: the FLOPs charged to the aten ops run under it, plus what
    `add` is given (the kernels' operations)."""

    def __init__(self):
        super().__init__()
        self.total = 0.0

    def add(self, flops: float) -> None:
        self.total += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in RULES:
            # Under inference mode the composite ops (conv2d, linear,
            # matmul, einsum) reach the mode whole: count their parts.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        rule = RULES.get(func.overloadpacket)
        if rule is not None:
            self.total += rule(args, out)
        return out


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_PEAK)


def _samples(lo, hi, size: int, out_size: int, ratio: int, scale: float):
    """A box axis's sample coordinates [..., n], clamped, and validity."""
    n = out_size * ratio
    s = torch.arange(n, dtype=torch.float32, device=lo.device)
    pos = torch.floor(s / ratio) + (s % ratio + 0.5) / ratio
    start = lo.float() * scale
    length = (hi.float() * scale - start).clamp(min=1.0)
    c = start[..., None] + pos * (length / out_size)[..., None]
    valid = (c >= -1.0) & (c <= float(size))
    return c.clamp(0.0, float(size - 1)), valid


def _roi_level(boxes, on, hw, c: int, esz: int, out_size: int,
               ratio: int, scale: float):
    """(feature bytes read, operations, operations of the backward) of
    the ROIs `on` [B, K] pooled from one [B, H, W, C] map: the pixels in
    the union of the ROIs' tap rectangles, and per ROI 2 C (row taps x
    columns read + column taps x sample rows), as the separable
    interpolation needs them."""
    h, w = hw
    n = out_size * ratio
    cy, vy = _samples(boxes[..., 1], boxes[..., 3], h, out_size, ratio,
                      scale)
    cx, vx = _samples(boxes[..., 0], boxes[..., 2], w, out_size, ratio,
                      scale)

    def taps(cc, v):
        return torch.where(v, 1.0 + (cc != torch.floor(cc)).float(),
                           torch.zeros_like(cc))

    def span(cc, v, size):
        lo = torch.where(v, torch.floor(cc), torch.full_like(cc, size))
        hi = torch.where(v, torch.ceil(cc), torch.full_like(cc, -1.0))
        return lo.amin(-1), hi.amax(-1)

    ty, tx = taps(cy, vy).sum(-1), taps(cx, vx).sum(-1)      # [B, K]
    x0, x1 = span(cx, vx, w)
    y0, y1 = span(cy, vy, h)
    cols = (x1 - x0 + 1).clamp(min=0)
    ok = on & (cols > 0) & (y1 >= y0)
    ops = float((2.0 * c * (ty * cols + tx * n) * ok).sum())
    # Union of the rectangles a map: a 2-D difference array.
    b = boxes.shape[0]
    grid = torch.zeros((b, h + 1, w + 1), device=boxes.device)
    bi = torch.arange(b, device=boxes.device)[:, None].expand_as(ok)[ok]
    ya, yb = y0[ok].long(), y1[ok].long() + 1
    xa, xb = x0[ok].long(), x1[ok].long() + 1
    one = torch.ones_like(ya, dtype=torch.float32)
    for yy, xx, sgn in ((ya, xa, 1), (ya, xb, -1), (yb, xa, -1),
                        (yb, xb, 1)):
        grid.index_put_((bi, yy, xx), sgn * one, accumulate=True)
    cover = grid.cumsum(1).cumsum(2)[:, :h, :w] > 0
    return float(cover.sum()) * c * esz, ops


def roi_align_work(args, kwargs) -> Dict:
    features, boxes = args[0], args[1]
    out_size = args[2] if len(args) > 2 else kwargs.get("out_size", 7)
    scale = args[3] if len(args) > 3 else kwargs.get("spatial_scale", 0.25)
    ratio = args[4] if len(args) > 4 else kwargs.get("sampling_ratio", 2)
    b, h, w, c = features.shape
    k = boxes.shape[1]
    esz = features.element_size()
    on = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    feat_bytes, ops = _roi_level(boxes, on, (h, w), c, esz, out_size,
                                 ratio, scale)
    pooled = b * k * out_size * out_size * c * esz
    side = boxes.numel() * 4
    return {"fwd": (feat_bytes + pooled + side, ops),
            "bwd": (pooled + b * h * w * c * esz + side, ops)}


def _levels(boxes):
    b = boxes.float()
    area = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=1e-12)
    lvl = torch.floor(4 + torch.log2(
        area.sqrt() / torch.full_like(area, 224.0) + 1e-6))
    return lvl.clamp(2, 5).long() - 2


def ms_roi_align_work(args, kwargs) -> Dict:
    feats: Sequence[torch.Tensor] = args[0]
    boxes = args[1]
    out_size = args[2] if len(args) > 2 else kwargs.get("out_size", 7)
    ratio = args[3] if len(args) > 3 else kwargs.get("sampling_ratio", 2)
    b, k = boxes.shape[:2]
    c, esz = feats[0].shape[-1], feats[0].element_size()
    levels = _levels(boxes)
    feat_bytes = ops = full = 0.0
    for lvl, f in enumerate(feats[:4]):
        fb, o = _roi_level(boxes, levels == lvl, tuple(f.shape[1:3]), c,
                           esz, out_size, ratio, 0.25 / 2 ** lvl)
        feat_bytes += fb
        ops += o
        full += f.numel() * esz
    pooled = b * k * out_size * out_size * c * esz
    side = boxes.numel() * 4
    return {"fwd": (feat_bytes + pooled + side, ops),
            "bwd": (pooled + full + side, ops)}


def match_anchors_work(args, kwargs) -> Dict:
    anchors, gt_boxes, gt_valid = args[0], args[1], args[2]
    full = args[3] if len(args) > 3 else kwargs.get("full", True)
    b, i = gt_valid.shape
    n = anchors.shape[0]
    pairs = float(gt_valid.sum()) * n
    ops = (20.0 if full else 16.0) * pairs
    nbytes = n * 16 + b * i * 17 + b * n * 4 + (
        b * n * 16 + b * i * 8 if full else 0)
    return {"fwd": (float(nbytes), ops), "bwd": (0.0, 0.0)}


WORK = {"roi_align": roi_align_work, "ms_roi_align": ms_roi_align_work,
        "match_anchors": match_anchors_work}


def peak_flops(name: str) -> Optional[float]:
    """The dense bf16 peak of an H100 SXM; None for another card."""
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        return BF16_PEAK
    return None
