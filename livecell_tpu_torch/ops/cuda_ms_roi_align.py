"""Multiscale (FPN) RoIAlign through the hand-written Hopper kernels of
csrc/ms_roi_align.cu (counterpart of livecell_tpu/ops/pallas_ms_roi.py:
assign_levels, ms_roi_align_pallas).

  `assign_levels` boxes [B,K,4] -> the torchvision LevelMapper level of
     each ROI, 0..3 for P2..P5, int32: a plain tensor op, computed once
     per call and handed to the kernels and their plain versions alike.
  K5 `ms_roi_align_fwd` four maps [B,H_l,W_l,C], boxes, levels ->
     [B,K,n,n,C]: each ROI pooled from its own level only.
  K6 `ms_roi_align_bwd` g [B,K,n,n,C], boxes, levels -> the four maps'
     gradients, weights recomputed inside the kernel.

As for every kernel of the port: a launch counter per wrapper
(`<wrapper>.launches`), a plain PyTorch version beside it, and a wrapper
that computes the plain version on CPU tensors and launches the kernel,
or raises, on CUDA tensors. The plain versions are the JAX composition's
own semantics: per level, K1's and K2's (K3's) plain versions over every
ROI with the weights of the other levels' ROIs zeroed.
`ms_roi_align` composes them through `MSRoIAlignFunction` (K5 forward,
K6 backward); boxes get no gradient (pallas_ms_roi.py:29-31).

Rounding as K1-K3: bf16 maps take bf16 weights and give bf16 output with
the row contraction rounded to bf16; the backward sums dF in f32 and
rounds it once; f32 maps keep f32 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from livecell_tpu_torch.config import ROUTES
from livecell_tpu_torch.ops import _build
from livecell_tpu_torch.ops.cuda_roi_align import (
    _DTYPES, _require_cuda, _stream, roi_align_fwd_plain, roi_weights_plain)

LEVELS = 4
# The plain versions pool ROIs in chunks whose f32 intermediates
# [B, chunk, n, W, C] stay under this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 27


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ms_roi_align")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.livecell_ms_roi_align_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              i, i, p]
    lib.livecell_ms_roi_align_fwd.restype = i
    lib.livecell_ms_roi_align_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              i, i, p]
    lib.livecell_ms_roi_align_bwd.restype = i
    lib.livecell_ms_roi_align_error_string.argtypes = [i]
    lib.livecell_ms_roi_align_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().livecell_ms_roi_align_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def assign_levels(boxes: torch.Tensor, canonical_size: float = 224.0,
                  canonical_level: int = 4) -> torch.Tensor:
    """torchvision LevelMapper: floor(k0 + log2(sqrt(area) / 224 + 1e-6))
    clamped to [2, 5], as a 0-based level [..., K] int32 (the JAX
    package's formula, in f32)."""
    b = boxes.float()
    area = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=1e-12)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal.
    lvl = torch.floor(canonical_level + torch.log2(
        area.sqrt() / torch.full_like(area, canonical_size) + 1e-6))
    return (lvl.clamp(2, 5) - 2).to(torch.int32)


def _chunks(k: int, per_roi: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(per_roi, 1))
    return [slice(s, min(s + step, k)) for s in range(0, k, step)]


def level_weights(boxes, levels, level, hw, out_size, ratio, dtype):
    """K1's plain weights (Wy [B,K,n,H], Wx [B,K,n,W]) on level `level`
    (P2..P5 at scale 1/4 .. 1/32), zero for the ROIs of other levels."""
    wy, wx = roi_weights_plain(boxes, hw, out_size, ratio,
                               0.25 / 2 ** level, dtype)
    on = (levels == level)[..., None, None].to(dtype)
    return wy * on, wx * on


def _check_inputs(feats, boxes, levels) -> Tuple[int, int, int]:
    if len(feats) != LEVELS:
        raise ValueError(f"expected {LEVELS} level maps, got {len(feats)}")
    b, k = boxes.shape[:2]
    c = feats[0].shape[-1]
    for f in feats:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c \
                or f.dtype != feats[0].dtype:
            raise ValueError(f"level maps must be [B, H_l, W_l, C] of one "
                             f"dtype, got {[tuple(x.shape) for x in feats]}")
    if tuple(boxes.shape) != (b, k, 4) or tuple(levels.shape) != (b, k):
        raise ValueError(f"boxes {tuple(boxes.shape)} and levels "
                         f"{tuple(levels.shape)} do not fit B={b}")
    return b, k, c


# ---------------------------------------------------------------------------
# K5: the forward.
# ---------------------------------------------------------------------------

def ms_roi_align_fwd_plain(feats: Sequence[torch.Tensor],
                           boxes: torch.Tensor, levels: torch.Tensor,
                           out_size: int = 7, sampling_ratio: int = 2
                           ) -> torch.Tensor:
    """Plain version of K5: per level, K1's and K2's plain versions over
    every ROI with the other levels' ROIs' weights zeroed, summed."""
    b, k, c = _check_inputs(feats, boxes, levels)
    dtype = feats[0].dtype
    out = torch.zeros((b, k, out_size, out_size, c), dtype=dtype,
                      device=boxes.device)
    for lvl, f in enumerate(feats):
        hw = tuple(f.shape[1:3])
        for s in _chunks(k, b * out_size * hw[1] * c):
            wy, wx = level_weights(boxes[:, s], levels[:, s], lvl, hw,
                                   out_size, sampling_ratio, dtype)
            out[:, s] += roi_align_fwd_plain(f, wy, wx)
    return out


def ms_roi_align_fwd(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                     levels: torch.Tensor, out_size: int = 7,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """K5 wrapper: four maps [B,H_l,W_l,C] (P2..P5, bf16 or f32, one
    dtype), boxes [B,K,4] f32, levels [B,K] int32 (`assign_levels`) ->
    [B, K, out_size, out_size, C] in the maps' dtype."""
    if boxes.device.type == "cpu":
        return ms_roi_align_fwd_plain(feats, boxes, levels, out_size,
                                      sampling_ratio)
    dev = _require_cuda(*feats, boxes, levels)
    b, k, c = _check_inputs(feats, boxes, levels)
    dtype = feats[0].dtype
    if dtype not in _DTYPES or boxes.dtype != torch.float32 \
            or levels.dtype != torch.int32:
        raise ValueError(f"ms_roi_align_fwd kernel takes bf16 or f32 maps, "
                         f"f32 boxes and int32 levels, got {dtype}, "
                         f"{boxes.dtype}, {levels.dtype}")
    hs = [f.shape[1] for f in feats]
    ws = [f.shape[2] for f in feats]
    # The kernel stages a ROI's 2n weight rows in shared memory.
    if out_size * max(h + w for h, w in zip(hs, ws)) * 4 + 16 * out_size \
            > 200 * 1024:
        raise ValueError(f"level maps {list(zip(hs, ws))} too large for the "
                         f"ms_roi_align_fwd kernel's shared-memory staging")
    out = torch.empty((b, k, out_size, out_size, c), dtype=dtype, device=dev)
    code = _lib().livecell_ms_roi_align_fwd(
        (ctypes.c_void_p * LEVELS)(*(f.data_ptr() for f in feats)),
        (ctypes.c_int * LEVELS)(*hs), (ctypes.c_int * LEVELS)(*ws),
        boxes.data_ptr(), levels.data_ptr(), out.data_ptr(), b, k, out_size,
        c, sampling_ratio, int(dtype == torch.bfloat16), _stream(dev))
    _check(code, "ms_roi_align_fwd")
    ms_roi_align_fwd.launches += 1
    return out


ms_roi_align_fwd.launches = 0


# ---------------------------------------------------------------------------
# K6: the backward with respect to the four maps.
# ---------------------------------------------------------------------------

def ms_roi_align_bwd_plain(g: torch.Tensor, boxes: torch.Tensor,
                           levels: torch.Tensor,
                           feat_hw: Sequence[Tuple[int, int]],
                           sampling_ratio: int = 2
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K6: per level, K3's plain version over every ROI
    with the other levels' ROIs' weights zeroed: u = sum_q Wx g (rounded
    to bf16 for bf16 g), dF = sum_k sum_p Wy u in f32, cast once."""
    b, k, n, _, c = g.shape
    out = []
    for lvl, (h, w) in enumerate(feat_hw):
        d = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
        for s in _chunks(k, b * n * w * c):
            wy, wx = level_weights(boxes[:, s], levels[:, s], lvl, (h, w),
                                   n, sampling_ratio, g.dtype)
            u = torch.einsum("bkqw,bkpqc->bkpwc", wx.float(),
                             g[:, s].float())
            if g.dtype == torch.bfloat16:
                u = u.to(torch.bfloat16).float()
            d += torch.einsum("bkph,bkpwc->bhwc", wy.float(), u)
        out.append(d.to(g.dtype))
    return tuple(out)


def ms_roi_align_bwd(g: torch.Tensor, boxes: torch.Tensor,
                     levels: torch.Tensor,
                     feat_hw: Sequence[Tuple[int, int]],
                     sampling_ratio: int = 2) -> Tuple[torch.Tensor, ...]:
    """K6 wrapper: g [B,K,n,n,C] (bf16 or f32), boxes [B,K,4] f32, levels
    [B,K] int32, the four maps' (H_l, W_l) -> their gradients
    [B,H_l,W_l,C] in g's dtype."""
    if g.device.type == "cpu":
        return ms_roi_align_bwd_plain(g, boxes, levels, feat_hw,
                                      sampling_ratio)
    dev = _require_cuda(g, boxes, levels)
    b, k, n, _, c = g.shape
    if g.dtype not in _DTYPES or boxes.dtype != torch.float32 \
            or levels.dtype != torch.int32:
        raise ValueError(f"ms_roi_align_bwd kernel takes bf16 or f32 g, f32 "
                         f"boxes and int32 levels, got {g.dtype}, "
                         f"{boxes.dtype}, {levels.dtype}")
    if len(feat_hw) != LEVELS or tuple(g.shape) != (b, k, n, n, c) \
            or tuple(boxes.shape) != (b, k, 4) \
            or tuple(levels.shape) != (b, k) or n > 16:
        raise ValueError(f"g {tuple(g.shape)}, boxes {tuple(boxes.shape)}, "
                         f"levels {tuple(levels.shape)} and {len(feat_hw)} "
                         f"maps do not fit (4 maps, at most 16 bins)")
    widest = max(w for _, w in feat_hw)
    # A feature row's f32 sums for 128 channels, a ROI's Wx rows and the
    # threads' g values in shared memory.
    if (widest * 128 + n * widest + n * 128) * 4 + 8 * widest > 200 * 1024:
        raise ValueError(f"level width {widest} too large for the "
                         f"ms_roi_align_bwd kernel's shared-memory row")
    dfeats = [torch.empty((b, h, w, c), dtype=g.dtype, device=dev)
              for h, w in feat_hw]
    code = _lib().livecell_ms_roi_align_bwd(
        (ctypes.c_void_p * LEVELS)(*(d.data_ptr() for d in dfeats)),
        (ctypes.c_int * LEVELS)(*(h for h, _ in feat_hw)),
        (ctypes.c_int * LEVELS)(*(w for _, w in feat_hw)),
        g.data_ptr(), boxes.data_ptr(), levels.data_ptr(), b, k, n, c,
        sampling_ratio, int(g.dtype == torch.bfloat16), _stream(dev))
    _check(code, "ms_roi_align_bwd")
    ms_roi_align_bwd.launches += 1
    return tuple(dfeats)


ms_roi_align_bwd.launches = 0


# ---------------------------------------------------------------------------
# The composed op.
# ---------------------------------------------------------------------------

class MSRoIAlignFunction(torch.autograd.Function):
    """K5 forward, K6 backward (or their plain versions when `plain`).
    Saves only the boxes and the levels; boxes get no gradient. Autocast
    is off inside: the kernels take the maps' own dtype."""

    @staticmethod
    def forward(ctx, boxes, out_size, sampling_ratio, plain, *feats):
        fwd = ms_roi_align_fwd_plain if plain else ms_roi_align_fwd
        with torch.autocast(boxes.device.type, enabled=False):
            levels = assign_levels(boxes)
            out = fwd(feats, boxes, levels, out_size, sampling_ratio)
        ctx.save_for_backward(boxes, levels)
        ctx.plain = plain
        ctx.ratio = sampling_ratio
        ctx.feat_hw = [tuple(f.shape[1:3]) for f in feats]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        boxes, levels = ctx.saved_tensors
        bwd = ms_roi_align_bwd_plain if ctx.plain else ms_roi_align_bwd
        with torch.autocast(g.device.type, enabled=False):
            dfeats = bwd(g.contiguous(), boxes, levels, ctx.feat_hw,
                         ctx.ratio)
        return (None, None, None, None) + tuple(dfeats)


def ms_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                 out_size: int = 7, sampling_ratio: int = 2,
                 backend: str = "auto") -> torch.Tensor:
    """Batched MultiScaleRoIAlign: four maps [B,H_l,W_l,C] (P2..P5),
    boxes [B,K,4] in image coordinates -> [B,K,s,s,C], differentiable in
    the maps.

    backend "auto": K5 and K6 through their wrappers (kernels on CUDA
    tensors, plain versions on CPU tensors); "kernel": the same, and CPU
    tensors are refused; "plain": the plain versions on any device."""
    if backend not in ROUTES:
        raise ValueError(f"roi_backend must be one of {ROUTES}, "
                         f"got {backend!r}")
    if backend == "kernel" and boxes.device.type != "cuda":
        raise ValueError("roi_backend='kernel' needs CUDA tensors")
    return MSRoIAlignFunction.apply(
        boxes.float().contiguous(), out_size, sampling_ratio,
        backend == "plain", *(f.contiguous() for f in feats))
