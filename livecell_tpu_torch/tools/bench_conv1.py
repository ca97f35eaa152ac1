"""Time three forms of the stem convolution (7x7, stride 2, C_in = 3) on
the H100 (counterpart of scripts/bench_conv1.py).

The question for this card: does the 7x7 stride-2 stem with three input
channels starve the tensor cores, as it starved the TPU's MXU, and does
cuDNN or cuBLAS run a regrouped form better? Each form computes the
reference's nn.Conv2d(3, 64, 7, stride=2, padding=3) at 16 x 304 x 224
x 3 -> 64 channels, in channels_last:

  plain : F.conv2d (cuDNN), what models/resnet.py runs;
  s2d   : space-to-depth by 2, then a 4x4 stride-1 convolution over 12
          channels, the kernel regrouped by input-coordinate parity
          (JAX's `_s2d_kernel` rule);
  im2col: 49 strided slices -> [B, Ho, Wo, 147] patches -> one matmul.

These are library calls by design: the study asks which form cuDNN and
cuBLAS run best. None is a kernel of the port.

    python -m livecell_tpu_torch.tools.bench_conv1

First each form is checked against `plain` in f32 (TF32 off) and one
line {"check", "rel_err"} printed; then fwd and fwd+wgrad are timed in
bf16 by CUDA events over 30 calls back to back
(utils/profiling.per_call_ms; JAX: a 30-iteration in-graph scan), one
line {"variant", "fwd_ms", "fwd_wgrad_ms", "card"} each. Runs on the
card; `main([...], device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.utils.flops import card_of
from livecell_tpu_torch.utils.profiling import per_call_ms

BATCH, HEIGHT, WIDTH, OUT = 16, 304, 224, 64
CALLS = 30


def conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W], w [O, 3, 7, 7] -> [B, O, H / 2, W / 2]."""
    return F.conv2d(x, w, stride=2, padding=3)


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """Regroup an [O, C, 7, 7] stride-2 kernel into [O, 4C, 4, 4] over a
    space-to-depth(2) input, channel order (ey, ex, c): JAX's
    `_s2d_kernel` rule in OIHW."""
    o, c = w.shape[:2]
    w4 = w.new_zeros((o, 4 * c, 4, 4))
    for ky in range(7):
        ey, ty = (ky + 1) % 2, (ky - 3 - (ky + 1) % 2) // 2 + 2
        for kx in range(7):
            ex, tx = (kx + 1) % 2, (kx - 3 - (kx + 1) % 2) // 2 + 2
            g = (ey * 2 + ex) * c
            w4[:, g:g + c, ty, tx] = w[:, :, ky, kx]
    return w4


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H / 2, W / 2], channels (ey, ex, c)."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    return nhwc.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)


def conv_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xs = F.pad(space_to_depth(x), (2, 1, 2, 1))
    return F.conv2d(xs, s2d_kernel(w))


def conv_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, c, h, wd = x.shape
    ho, wo = h // 2, wd // 2
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 3, 3, 3, 3))   # NHWC
    cols = [xp[:, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2, :]
            for ky in range(7) for kx in range(7)]
    patches = torch.cat(cols, dim=-1)                      # [B,Ho,Wo,49C]
    kmat = w.permute(2, 3, 1, 0).reshape(49 * c, -1)       # (ky, kx, c)
    return (patches @ kmat).permute(0, 3, 1, 2)


VARIANTS = {"plain": conv_plain, "s2d": conv_s2d, "im2col": conv_im2col}


@contextlib.contextmanager
def exact_f32():
    """TF32 off in cuDNN and cuBLAS for the body (cuDNN's default is on)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def main(argv=None, device=None) -> List[Dict]:
    """Returns the printed lines as dicts."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.normal(size=(BATCH, HEIGHT, WIDTH, 3))
                           .astype(np.float32)).to(dev).permute(0, 3, 1, 2)
    k32 = torch.from_numpy(rng.normal(size=(7, 7, 3, OUT)).astype(np.float32)
                           * 0.1).to(dev).permute(3, 2, 0, 1).contiguous()
    rows = []
    with exact_f32():
        ref = conv_plain(x32, k32)
        for name, fn in VARIANTS.items():
            got = fn(x32, k32)
            err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
            rows.append({"check": name, "rel_err": err})
            print(json.dumps(rows[-1]), flush=True)

    x = x32.to(torch.bfloat16)
    k = k32.to(torch.bfloat16)
    g0 = torch.from_numpy(rng.normal(size=(BATCH, HEIGHT // 2, WIDTH // 2,
                                           OUT)).astype(np.float32)
                          ).to(dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    card = card_of(dev)
    for name, fn in VARIANTS.items():
        kk = k.clone().requires_grad_(True)

        def fwd_wgrad(fn=fn, kk=kk):
            return torch.autograd.grad(fn(x, kk), kk, g0)[0]

        with torch.no_grad():
            fwd_ms = per_call_ms(lambda: fn(x, k), dev, calls=CALLS)
        rows.append({"variant": name, "fwd_ms": round(fwd_ms, 3),
                     "fwd_wgrad_ms": round(per_call_ms(fwd_wgrad, dev,
                                                       calls=CALLS), 3),
                     "card": card})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
