"""RoIAlign through the hand-written Hopper kernels of csrc/roi_align.cu
(counterpart of livecell_tpu/ops/pallas_roi_align.py).

Three kernels, each with a wrapper, a plain PyTorch version and a launch
counter (`<wrapper>.launches`, raised by one per kernel launch):

  K1 `roi_weights`   boxes [B,K,4] f32 -> Wy [B,K,n,H], Wx [B,K,n,W]:
     the pooled bilinear weights (replaces `_weights_kernel`): a thread
     a 16-byte vector, each row's constants once, the taps only near
     its samples (`roi_weights_rows_plain` replays that on the CPU).
  K2 `roi_align_fwd` features [B,H,W,C], Wy, Wx -> [B,K,n,n,C]
     (replaces `_fwd_kernel`): one block per ROI lists each weight row's
     non-zero taps (`roi_taps_plain` is that list's plain version), then
     its warps gather the bins.
  K3 `roi_align_bwd` g [B,K,n,n,C], Wy, Wx -> dfeatures [B,H,W,C]
     (replaces `_bwd_kernel`): the pre-pass `roi_spans` (each ROI's
     non-zero row and column span) then the tiled gather; one count per
     call for the two launches.

Each wrapper and its plain version are charged to an active FLOP
counter as the Pallas kernel they replace (utils/flops.py: K1 nothing,
K2 and K3 `roi_pool_flops`).

A wrapper given CPU tensors computes its plain version; given CUDA
tensors it launches its kernel or raises on a dtype, shape or layout
the kernel does not take. There is no fallback from one to the other.
`roi_align` composes them under the model's `roi_backend` through
`RoIAlignFunction`, whose backward is K3 on K1's weights (the custom
VJP's residuals, pallas_roi_align.py:269-277); boxes get no gradient.

bf16 features take bf16 weights and give bf16 output with the row
contraction rounded to bf16, where the Pallas kernel rounds; f32
features keep everything in f32 (the JAX einsum path at "highest").
The same holds backward: bf16 g, u = sum_q Wx g rounded to bf16, dF
summed in f32 and rounded once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from livecell_tpu_torch.config import ROUTES
from livecell_tpu_torch.ops import _build
from livecell_tpu_torch.utils.flops import charged, roi_pool_flops

_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.livecell_roi_weights.argtypes = [p, p, p, ll, i, i, i, i,
                                         ctypes.c_float, i, p]
    lib.livecell_roi_weights.restype = i
    lib.livecell_roi_align_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           p]
    lib.livecell_roi_align_fwd.restype = i
    lib.livecell_roi_spans.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.livecell_roi_spans.restype = i
    lib.livecell_roi_align_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, p]
    lib.livecell_roi_align_bwd.restype = i
    for fn in (lib.livecell_roi_align_fwd_blocks_per_sm,
               lib.livecell_roi_align_bwd_blocks_per_sm):
        fn.argtypes = [i]
        fn.restype = i
    lib.livecell_cuda_error_string.argtypes = [i]
    lib.livecell_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().livecell_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The tensors' device: one CUDA device, the current one (the kernel
    launches there), with every tensor contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"expected tensors on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# The RoIAlign gathers (K2, K3, K5, K6) load and store a lane's 8
# channels as 16-byte vectors, and take at most 16 bins; the forward's
# tap lists (K2, K5) hold 2 * MAX_RATIO taps a weight row (K2 gathers a
# ROI with a longer row from the weight rows themselves, K5's wrapper
# refuses a larger sampling ratio).
VEC_CHANNELS = 8
MAX_BINS = 16
MAX_RATIO = 4


def _check_tiled(what: str, n: int, c: int) -> None:
    if n > MAX_BINS:
        raise ValueError(f"{what} kernel takes at most {MAX_BINS} bins, "
                         f"got {n}")
    if c % VEC_CHANNELS:
        raise ValueError(f"{what} kernel takes channels in multiples of "
                         f"{VEC_CHANNELS}, got {c}")


def _require_aligned(*tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("expected 16-byte aligned tensors")


# ---------------------------------------------------------------------------
# K1: pooled bilinear weights.
# ---------------------------------------------------------------------------

def _k1_flops(*args, **kwargs) -> float:
    """The Pallas weights kernel's body holds no dot_general."""
    return 0.0


def _k2_flops(features, wy, wx) -> float:
    b, h, w, c = features.shape
    return roi_pool_flops(b, wy.shape[1], wy.shape[2], h, w, c)


def _k3_flops(g, wy, wx, feat_hw) -> float:
    b, k, n, _, c = g.shape
    return roi_pool_flops(b, k, n, feat_hw[0], feat_hw[1], c)


@charged(_k1_flops)
def roi_weights_plain(boxes: torch.Tensor, feat_hw: Tuple[int, int],
                      out_size: int = 7, sampling_ratio: int = 2,
                      spatial_scale: float = 0.25,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the Pallas `_axis_weights` in f32, rounded
    once to `dtype`. boxes [B, K, 4] -> (Wy [B,K,n,H], Wx [B,K,n,W])."""
    boxes = boxes.float()
    p = torch.arange(out_size, dtype=torch.float32, device=boxes.device)

    def axis(lo, hi, size):
        start = lo * spatial_scale
        length = (hi * spatial_scale - start).clamp(min=1.0)
        # A tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds differently from
        # the kernel's (and JAX's) true division.
        bin_sz = length / torch.full_like(length, out_size)
        grid = torch.arange(size, dtype=torch.float32, device=boxes.device)
        w = torch.zeros(lo.shape + (out_size, size), dtype=torch.float32,
                        device=boxes.device)
        for s in range(sampling_ratio):
            c = start[..., None] + (p + (s + 0.5) / sampling_ratio) \
                * bin_sz[..., None]
            valid = (c >= -1.0) & (c <= float(size))
            cc = c.clamp(0.0, float(size - 1))
            tap = (1.0 - (cc[..., None] - grid).abs()).clamp(min=0.0)
            w = w + tap * valid[..., None]
        return (w / torch.full_like(w, sampling_ratio)).to(dtype)

    return (axis(boxes[..., 1], boxes[..., 3], feat_hw[0]),
            axis(boxes[..., 0], boxes[..., 2], feat_hw[1]))


@charged(_k1_flops)
def roi_weights(boxes: torch.Tensor, feat_hw: Tuple[int, int],
                out_size: int = 7, sampling_ratio: int = 2,
                spatial_scale: float = 0.25,
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: boxes [B, K, 4] float32 -> (Wy [B,K,n,H],
    Wx [B,K,n,W]) in `dtype` (bf16 or f32)."""
    if boxes.device.type == "cpu":
        return roi_weights_plain(boxes, feat_hw, out_size, sampling_ratio,
                                 spatial_scale, dtype)
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[-1] != 4:
        raise ValueError(f"roi_weights kernel takes float32 [B, K, 4] "
                         f"boxes, got {boxes.dtype} {tuple(boxes.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"roi_weights kernel writes bf16 or f32, not {dtype}")
    b, k = boxes.shape[:2]
    h, w = feat_hw
    # The kernel indexes each tensor with 32-bit ints.
    if sampling_ratio < 1 or b * k * out_size * max(h, w) >= 2 ** 31:
        raise ValueError(f"roi_weights kernel takes sampling_ratio >= 1 and "
                         f"fewer than 2^31 weights a tensor, got "
                         f"{sampling_ratio} and {b}x{k}x{out_size}x"
                         f"{max(h, w)}")
    dev = _require_cuda(boxes)
    wy = torch.empty((b, k, out_size, h), dtype=dtype, device=dev)
    wx = torch.empty((b, k, out_size, w), dtype=dtype, device=dev)
    code = _lib().livecell_roi_weights(
        boxes.data_ptr(), wy.data_ptr(), wx.data_ptr(), b * k, out_size, h, w,
        sampling_ratio, spatial_scale, int(dtype == torch.bfloat16),
        _stream(dev))
    _check(code, "roi_weights")
    roi_weights.launches += 1
    return wy, wx


roi_weights.launches = 0


def roi_weights_rows_plain(boxes: torch.Tensor, feat_hw: Tuple[int, int],
                           out_size: int = 7, sampling_ratio: int = 2,
                           spatial_scale: float = 0.25,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain emulation of K1's decomposition, for the tests: each weight
    row's constants once (start, bin side), each valid sample's clamped
    coordinate cc once, and its taps only on pixels floor(cc) and
    floor(cc) + 1 (+0 elsewhere), summed over the samples in order; the
    mean a division by the ratio. The float operations are
    `roi_weights_plain`'s, but the side floors at 1 pixel as the
    kernel's fmaxf does, NaN included (roi_weights_plain's clamp passes a
    NaN on). A call too small to fill the card runs pooled_weight per
    element instead, the plain version's own formula. boxes [B, K, 4] ->
    (Wy [B,K,n,H], Wx [B,K,n,W]) in `dtype`."""
    boxes = boxes.float()
    p = torch.arange(out_size, dtype=torch.float32, device=boxes.device)

    def axis(lo, hi, size):
        start = lo * spatial_scale
        length = torch.fmax(hi * spatial_scale - start,
                            torch.ones_like(start))
        bin_sz = length / torch.full_like(length, out_size)
        grid = torch.arange(size, dtype=torch.float32, device=boxes.device)
        pix = torch.arange(size, device=boxes.device)
        acc = torch.zeros(lo.shape + (out_size, size), dtype=torch.float32,
                          device=boxes.device)
        for s in range(sampling_ratio):
            c = start[..., None] + (p + (s + 0.5) / sampling_ratio) \
                * bin_sz[..., None]
            valid = (c >= -1.0) & (c <= float(size))
            cc = c.clamp(0.0, float(size - 1))
            g0 = cc.nan_to_num().floor().long()[..., None]
            near = valid[..., None] & (pix >= g0) & (pix <= g0 + 1)
            tap = (1.0 - (cc[..., None] - grid).abs()).clamp(min=0.0)
            acc = torch.where(near, acc + tap, acc)
        return (acc / torch.full_like(acc, sampling_ratio)).to(dtype)

    return (axis(boxes[..., 1], boxes[..., 3], feat_hw[0]),
            axis(boxes[..., 0], boxes[..., 2], feat_hw[1]))


# ---------------------------------------------------------------------------
# K2: pooled-feature contraction.
# ---------------------------------------------------------------------------

@charged(_k2_flops)
def roi_align_fwd_plain(features: torch.Tensor, wy: torch.Tensor,
                        wx: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the row contraction and the column
    contraction with f32 accumulation; for bf16 features the row result
    is rounded to bf16 in between and the output is bf16."""
    t = torch.einsum("bkph,bhwc->bkpwc", wy.float(), features.float())
    if features.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16).float()
    out = torch.einsum("bkqw,bkpwc->bkpqc", wx.float(), t)
    return out.to(features.dtype)


@charged(_k2_flops)
def roi_align_fwd(features: torch.Tensor, wy: torch.Tensor,
                  wx: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: features [B,H,W,C] (NHWC), Wy [B,K,n,H], Wx [B,K,n,W]
    of the same dtype (bf16 or f32) -> [B, K, n, n, C]."""
    if features.device.type == "cpu":
        return roi_align_fwd_plain(features, wy, wx)
    b, h, w, c = features.shape
    k, n = wy.shape[1], wy.shape[2]
    if features.dtype not in _DTYPES or wy.dtype != features.dtype \
            or wx.dtype != features.dtype:
        raise ValueError(f"roi_align_fwd kernel takes bf16 or f32 features "
                         f"with weights of the same dtype, got "
                         f"{features.dtype}, {wy.dtype}, {wx.dtype}")
    if tuple(wy.shape) != (b, k, n, h) or tuple(wx.shape) != (b, k, n, w):
        raise ValueError(f"weights {tuple(wy.shape)}, {tuple(wx.shape)} do "
                         f"not fit features {tuple(features.shape)}")
    _check_tiled("roi_align_fwd", n, c)
    dev = _require_cuda(features, wy, wx)
    _require_aligned(features)
    out = torch.empty((b, k, n, n, c), dtype=features.dtype, device=dev)
    code = _lib().livecell_roi_align_fwd(
        features.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
        b, k, n, h, w, c, int(features.dtype == torch.bfloat16), _stream(dev))
    _check(code, "roi_align_fwd")
    roi_align_fwd.launches += 1
    return out


roi_align_fwd.launches = 0


def roi_align_fwd_blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of K2 resident on one SM of the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = _lib().livecell_roi_align_fwd_blocks_per_sm(
        int(dtype == torch.bfloat16))
    if blocks < 0:
        _check(-blocks, "roi_align_fwd occupancy")
    return blocks


def roi_taps_plain(wy: torch.Tensor, wx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels' tap lists (K2, K5): for each
    ROI's 2n weight rows (Wy [..., n, H] then Wx [..., n, W]), the pixels
    whose weight is non-zero, in ascending order, and their weights in
    f32. Returns (index [..., 2n, L] int32, -1 past a row's end; weight
    [..., 2n, L] f32, 0 there; count [..., 2n] int32), L the longest
    row's count: nothing is cut short."""
    def lists(wt):
        wt = wt.float()
        nz = wt != 0
        count = nz.sum(-1)
        size = wt.shape[-1]
        pix = torch.arange(size, device=wt.device)
        # Non-zero pixels first, each group in pixel order.
        order = torch.where(nz, pix, size + pix).argsort(-1)
        return order, wt.gather(-1, order), count

    (iy, vy, ny), (ix, vx, nx) = lists(wy), lists(wx)
    count = torch.cat([ny, nx], -1)
    width = int(count.max()) if count.numel() else 0

    def cut(t):
        pad = width - t.shape[-1]
        return torch.nn.functional.pad(t[..., :width], (0, max(pad, 0)))

    index = torch.cat([cut(iy), cut(ix)], -2)
    weight = torch.cat([cut(vy), cut(vx)], -2)
    live = torch.arange(width, device=wy.device) < count[..., None]
    return (torch.where(live, index, -1).to(torch.int32),
            torch.where(live, weight, 0.0), count.to(torch.int32))


# ---------------------------------------------------------------------------
# K3: the backward of K2 with respect to the features.
# ---------------------------------------------------------------------------

@charged(_k3_flops)
def roi_align_bwd_plain(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                        feat_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of K3: u = sum_q Wx g (f32, rounded to bf16 for bf16
    g), then dF = sum_k sum_p Wy u in f32, cast to g's dtype."""
    u = torch.einsum("bkqw,bkpqc->bkpwc", wx.float(), g.float())
    if g.dtype == torch.bfloat16:
        u = u.to(torch.bfloat16).float()
    d = torch.einsum("bkph,bkpwc->bhwc", wy.float(), u)
    return d.to(g.dtype)


def roi_spans_plain(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's pre-pass: each ROI's non-zero extent over its
    n weight rows, [B, K, 4] int32 (y_lo, y_hi, x_lo, x_hi), inclusive;
    an axis with no non-zero weight gets lo = size, hi = -1."""
    def axis(wt):
        size = wt.shape[-1]
        nz = (wt != 0).any(dim=-2)                       # [B, K, size]
        idx = torch.arange(size, device=wt.device)
        return (torch.where(nz, idx, size).amin(-1),
                torch.where(nz, idx, -1).amax(-1))

    (ylo, yhi), (xlo, xhi) = axis(wy), axis(wx)
    return torch.stack([ylo, yhi, xlo, xhi], dim=-1).to(torch.int32)


def roi_spans(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """K3's pre-pass alone (roi_align_bwd launches it itself): Wy
    [B,K,n,H], Wx [B,K,n,W] of one dtype -> [B, K, 4] int32 spans."""
    if wy.device.type == "cpu":
        return roi_spans_plain(wy, wx)
    b, k, n, h = wy.shape
    w = wx.shape[-1]
    if wy.dtype not in _DTYPES or wx.dtype != wy.dtype \
            or tuple(wx.shape) != (b, k, n, w):
        raise ValueError(f"roi_spans kernel takes bf16 or f32 weights of one "
                         f"dtype, got {wy.dtype} {tuple(wy.shape)}, "
                         f"{wx.dtype} {tuple(wx.shape)}")
    dev = _require_cuda(wy, wx)
    spans = torch.empty((b, k, 4), dtype=torch.int32, device=dev)
    _check(_lib().livecell_roi_spans(
        wy.data_ptr(), wx.data_ptr(), spans.data_ptr(), b * k, n, h, w,
        int(wy.dtype == torch.bfloat16), _stream(dev)), "roi_spans")
    return spans


@charged(_k3_flops)
def roi_align_bwd(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                  feat_hw: Tuple[int, int]) -> torch.Tensor:
    """K3 wrapper: g [B,K,n,n,C], Wy [B,K,n,H], Wx [B,K,n,W] of one dtype
    (bf16 or f32) -> dfeatures [B,H,W,C] in that dtype."""
    if g.device.type == "cpu":
        return roi_align_bwd_plain(g, wy, wx, feat_hw)
    b, k, n, _, c = g.shape
    h, w = feat_hw
    if g.dtype not in _DTYPES or wy.dtype != g.dtype or wx.dtype != g.dtype:
        raise ValueError(f"roi_align_bwd kernel takes bf16 or f32 g with "
                         f"weights of the same dtype, got {g.dtype}, "
                         f"{wy.dtype}, {wx.dtype}")
    if tuple(g.shape) != (b, k, n, n, c) or tuple(wy.shape) != (b, k, n, h) \
            or tuple(wx.shape) != (b, k, n, w):
        raise ValueError(f"g {tuple(g.shape)}, weights {tuple(wy.shape)}, "
                         f"{tuple(wx.shape)} do not fit a {h}x{w} map")
    _check_tiled("roi_align_bwd", n, c)
    dev = _require_cuda(g, wy, wx)
    _require_aligned(g)
    spans = torch.empty((b, k, 4), dtype=torch.int32, device=dev)
    dfeat = torch.empty((b, h, w, c), dtype=g.dtype, device=dev)
    code = _lib().livecell_roi_align_bwd(
        g.data_ptr(), wy.data_ptr(), wx.data_ptr(), spans.data_ptr(),
        dfeat.data_ptr(), b, k, n, h, w, c, int(g.dtype == torch.bfloat16),
        _stream(dev))
    _check(code, "roi_align_bwd")
    roi_align_bwd.launches += 1
    return dfeat


roi_align_bwd.launches = 0


def roi_align_bwd_blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of K3's main kernel resident on one SM of the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = _lib().livecell_roi_align_bwd_blocks_per_sm(
        int(dtype == torch.bfloat16))
    if blocks < 0:
        _check(-blocks, "roi_align_bwd occupancy")
    return blocks


# ---------------------------------------------------------------------------
# The composed op.
# ---------------------------------------------------------------------------

def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor,
                    out_size: int = 7, spatial_scale: float = 0.25,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of K1 then K2: features [B,H,W,C], boxes [B,K,4]
    -> [B, K, out_size, out_size, C] in features.dtype."""
    wy, wx = roi_weights_plain(boxes, features.shape[1:3], out_size,
                               sampling_ratio, spatial_scale,
                               features.dtype)
    return roi_align_fwd_plain(features, wy, wx)


class RoIAlignFunction(torch.autograd.Function):
    """K1 then K2 forward, K3 backward on K1's weights (or the three
    plain versions when `plain`). Boxes get no gradient, as in the
    custom VJP (pallas_roi_align.py:346). Autocast is off inside: the
    kernels and their plain versions take the features' own dtype."""

    @staticmethod
    def forward(ctx, features, boxes, out_size, spatial_scale,
                sampling_ratio, plain):
        weights = roi_weights_plain if plain else roi_weights
        fwd = roi_align_fwd_plain if plain else roi_align_fwd
        with torch.autocast(features.device.type, enabled=False):
            wy, wx = weights(boxes, features.shape[1:3], out_size,
                             sampling_ratio, spatial_scale, features.dtype)
            out = fwd(features, wy, wx)
        ctx.save_for_backward(wy, wx)
        ctx.plain = plain
        ctx.feat_hw = tuple(features.shape[1:3])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wy, wx = ctx.saved_tensors
        bwd = roi_align_bwd_plain if ctx.plain else roi_align_bwd
        with torch.autocast(g.device.type, enabled=False):
            dfeat = bwd(g.contiguous(), wy, wx, ctx.feat_hw)
        return dfeat, None, None, None, None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              out_size: int = 7, spatial_scale: float = 0.25,
              sampling_ratio: int = 2, backend: str = "auto"
              ) -> torch.Tensor:
    """Batched RoIAlign [B,H,W,C], [B,K,4] -> [B,K,s,s,C], differentiable
    in the features.

    backend "auto": K1, K2 and K3 through their wrappers (kernels on CUDA
    tensors, plain versions on CPU tensors); "kernel": the same, and CPU
    tensors are refused; "plain": the plain versions on any device."""
    if backend not in ROUTES:
        raise ValueError(f"roi_backend must be one of {ROUTES}, "
                         f"got {backend!r}")
    if backend == "kernel" and features.device.type != "cuda":
        raise ValueError("roi_backend='kernel' needs CUDA tensors")
    return RoIAlignFunction.apply(features, boxes, out_size, spatial_scale,
                                  sampling_ratio, backend == "plain")
