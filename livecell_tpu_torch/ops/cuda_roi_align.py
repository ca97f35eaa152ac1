"""RoIAlign through the hand-written Hopper kernels of csrc/roi_align.cu
(counterpart of livecell_tpu/ops/pallas_roi_align.py, forward only).

Two kernels, each with a wrapper, a plain PyTorch version and a launch
counter (`<wrapper>.launches`, raised by one per kernel launch):

  K1 `roi_weights`   boxes [B,K,4] f32 -> Wy [B,K,n,H], Wx [B,K,n,W]:
     the pooled bilinear weights (replaces `_weights_kernel`).
  K2 `roi_align_fwd` features [B,H,W,C], Wy, Wx -> [B,K,n,n,C]
     (replaces `_fwd_kernel`).

A wrapper given CPU tensors computes its plain version; given CUDA
tensors it launches its kernel or raises on a dtype, shape or layout
the kernel does not take. There is no fallback from one to the other.
`roi_align` composes the two under the model's `roi_backend`.

bf16 features take bf16 weights and give bf16 output with the row
contraction rounded to bf16, where the Pallas kernel rounds; f32
features keep everything in f32 (the JAX einsum path at "highest").

No autograd is registered for the kernel path: this is the serving
slice. The training slice adds the backward kernel as an
`autograd.Function` that reuses K1's weight tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from livecell_tpu_torch.ops import _build

_DTYPES = (torch.bfloat16, torch.float32)
BACKENDS = ("auto", "kernel", "plain")


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


# ---------------------------------------------------------------------------
# K1: pooled bilinear weights.
# ---------------------------------------------------------------------------

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
        return (w / sampling_ratio).to(dtype)

    return (axis(boxes[..., 1], boxes[..., 3], feat_hw[0]),
            axis(boxes[..., 0], boxes[..., 2], feat_hw[1]))


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
    dev = _require_cuda(boxes)
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[-1] != 4:
        raise ValueError(f"roi_weights kernel takes float32 [B, K, 4] "
                         f"boxes, got {boxes.dtype} {tuple(boxes.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"roi_weights kernel writes bf16 or f32, not {dtype}")
    b, k = boxes.shape[:2]
    h, w = feat_hw
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


# ---------------------------------------------------------------------------
# K2: pooled-feature contraction.
# ---------------------------------------------------------------------------

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


def roi_align_fwd(features: torch.Tensor, wy: torch.Tensor,
                  wx: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: features [B,H,W,C] (NHWC), Wy [B,K,n,H], Wx [B,K,n,W]
    of the same dtype (bf16 or f32) -> [B, K, n, n, C]."""
    if features.device.type == "cpu":
        return roi_align_fwd_plain(features, wy, wx)
    dev = _require_cuda(features, wy, wx)
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
    # The kernel stages a ROI's 2n weight rows in shared memory.
    if n * (h + w) * 4 + 16 * n > 200 * 1024:
        raise ValueError(f"feature map {h}x{w} too large for the "
                         f"roi_align_fwd kernel's shared-memory staging")
    out = torch.empty((b, k, n, n, c), dtype=features.dtype, device=dev)
    code = _lib().livecell_roi_align_fwd(
        features.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
        b, k, n, h, w, c, int(features.dtype == torch.bfloat16), _stream(dev))
    _check(code, "roi_align_fwd")
    roi_align_fwd.launches += 1
    return out


roi_align_fwd.launches = 0


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


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              out_size: int = 7, spatial_scale: float = 0.25,
              sampling_ratio: int = 2, backend: str = "auto"
              ) -> torch.Tensor:
    """Batched RoIAlign [B,H,W,C], [B,K,4] -> [B,K,s,s,C].

    backend "auto": K1 and K2 through their wrappers (kernels on CUDA
    tensors, plain versions on CPU tensors); "kernel": the same, and CPU
    tensors are refused; "plain": `roi_align_plain` on any device."""
    if backend not in BACKENDS:
        raise ValueError(f"roi_backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "plain":
        return roi_align_plain(features, boxes, out_size, spatial_scale,
                               sampling_ratio)
    if backend == "kernel" and features.device.type != "cuda":
        raise ValueError("roi_backend='kernel' needs CUDA tensors")
    wy, wx = roi_weights(boxes, features.shape[1:3], out_size,
                         sampling_ratio, spatial_scale, features.dtype)
    return roi_align_fwd(features, wy, wx)
