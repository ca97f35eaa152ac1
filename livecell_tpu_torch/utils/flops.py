"""Analytic matmul and convolution FLOP count of one call (counterpart of
livecell_tpu/utils/flops.py: count_flops, by its rules).

`count_flops(fn, *args)` runs `fn` once under a TorchDispatchMode that
sees every aten op of the call, the backward's too, and charges:

  * a matrix product (mm, addmm, bmm, baddbmm; `linear`, `matmul` and
    `einsum` reach the dispatcher as these) 2 * batch * M * N * K;
  * a convolution 2 * out_elems * fan_in * kspace, fan_in the kernel's
    input features per group (for a transposed convolution, which JAX
    writes as an lhs-dilated convolution, the input channels per group);
  * the backward of a convolution as JAX's autodiff emits it: the input
    gradient is a convolution over the input's shape, 2 * in_elems *
    (the forward's output channels per group) * kspace, so at stride 2
    four times the forward; the weight gradient equals the forward;
  * everything else nothing.

The hand-written kernels run through ctypes, out of the dispatcher's
sight. Each kernel's wrapper and its plain version carry `charged(rule)`:
the rule charges what livecell_tpu/utils/flops.py charges the Pallas
kernel the wrapper replaces (grid x the body's dot_generals, at the
Pallas blocking), and counting is suspended while the wrapper or its
plain version runs, so the count does not depend on the route: the CPU,
the kernels and the plain versions on the card count the same.

Unlike the JAX package's count, which traces, this one executes the
call: count a step on a copy of the model and optimizer where the real
state must not move.
"""

from __future__ import annotations

import functools
import math
import subprocess
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)

aten = torch.ops.aten


def _mm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args, out) -> float:
    return _mm(args[1:], out)


def _bmm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args, out) -> float:
    return _bmm(args[1:], out)


def _conv(args, out) -> float:
    weight, transposed, groups = args[1], args[6], args[8]
    kin = weight.shape[0] // groups if transposed else weight.shape[1]
    return 2.0 * out.numel() * kin * math.prod(weight.shape[2:])


def _conv_backward(args, out) -> float:
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


_RULES = {aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _bmm,
          aten.baddbmm: _baddbmm, aten.convolution: _conv,
          aten.convolution_backward: _conv_backward}


class FlopCounter(TorchDispatchMode):
    """Sums the charges of the aten ops run under it (`total`, and
    `by_op`, by op or kernel name). Kernel wrappers add theirs through
    `charged`."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.by_op: Dict[str, float] = defaultdict(float)
        self.suspended = 0

    def add(self, name: str, flops: float) -> None:
        self.total += flops
        self.by_op[name] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func.overloadpacket)
        if rule is None:
            # Under inference mode the composite ops (conv2d, linear,
            # matmul, einsum) reach the mode whole: their parts are
            # counted through their decomposition.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if rule is not None and not self.suspended:
            self.add(func.overloadpacket.__name__, rule(args, out))
        return out


def _active():
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, FlopCounter)]


def charged(rule: Callable[..., float]) -> Callable:
    """Decorator of a kernel's wrapper and of its plain version:
    `rule(*args, **kwargs)` of the call is charged to every active
    FlopCounter, and the counter ignores the aten ops the call runs.
    A call made inside another charged call adds nothing (the wrapper
    that takes its plain version on the CPU is charged once)."""

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            counters = [c for c in _active() if not c.suspended]
            for c in counters:
                c.add(fn.__name__, rule(*args, **kwargs))
                c.suspended += 1
            try:
                return fn(*args, **kwargs)
            finally:
                for c in counters:
                    c.suspended -= 1
        return run

    return deco


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """Total matmul and convolution FLOPs of one call of `fn`, which this
    runs (forward, and backward where `fn` calls it)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


# NVIDIA's dense bf16 tensor-core rate of the H100 SXM5 (data sheet), at
# its full 700 W power limit.
H100_BF16_PEAK = 989.4e12


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card, or "no card"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "no card" if not torch.cuda.is_available() else \
            torch.cuda.get_device_name(0) + ", power limit not read"
    return out.strip().splitlines()[0] if out.strip() else "no card"


def peak_flops(device) -> Optional[float]:
    """The dense bf16 peak of `device`'s card: H100_BF16_PEAK on an H100
    SXM, else None (no other card's figure is taken for it; the PCIe and
    NVL parts have lower rates)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        return None
    return H100_BF16_PEAK


def mfu_report(flops: float, seconds: float, device) -> str:
    """One line: the achieved TFLOP/s of `flops` in `seconds` and the MFU
    against the card's dense bf16 peak, with the card's name and power
    limit; MFU "unknown" on a card that is not an H100 (or the CPU)."""
    peak = peak_flops(device)
    rate = flops / seconds / 1e12
    where = card_name_and_power() if torch.device(device).type == "cuda" \
        else "the CPU"
    if peak is None:
        return (f"{rate:.3f} TFLOP/s on {where}; MFU unknown (no dense "
                f"bf16 peak for this device)")
    return (f"{rate:.3f} TFLOP/s on {where}; MFU {flops / seconds / peak:.4f}"
            f" of {peak / 1e12:.1f} TFLOP/s (H100 SXM5 dense bf16)")


# ---------------------------------------------------------------------------
# The Pallas kernels' charges: grid x the body's dot_generals, at the
# blocking livecell_tpu/ops/pallas_roi_align.py and pallas_match.py pick.
# ---------------------------------------------------------------------------

def _channel_block(c: int, preferred: int = 256) -> int:
    for cand in (preferred, 256, 128):
        if cand <= c and c % cand == 0:
            return cand
    return c


def pallas_roi_rows(k: int, out_size: int, w: int, c: int) -> int:
    """Kp: the ROI count the Pallas RoIAlign pads K to
    (pallas_roi_align.py:_forward): a block of 64 ROIs, halved while the
    f32 intermediate [KB * n, W * CB] exceeds 40 MiB, at most K rounded
    up to 8."""
    n = out_size + out_size % 2
    cb = _channel_block(c)
    kb = 64
    while kb > 8 and kb * n * w * cb * 4 > 40 * 1024 * 1024:
        kb //= 2
    kb = min(kb, -(-k // 8) * 8)
    return -(-k // kb) * kb


def roi_pool_flops(b: int, k: int, out_size: int, h: int, w: int,
                   c: int) -> float:
    """The Pallas RoIAlign forward's charge, which is also its backward's
    (_fwd_kernel and _bwd_kernel each hold two dot_generals, together
    2 * KB * n * W * CB * (H + n) a grid cell over (B, C / CB, Kp / KB)):
    2 * B * Kp * n * W * C * (H + n), n = out_size rounded up to even."""
    n = out_size + out_size % 2
    kp = pallas_roi_rows(k, out_size, w, c)
    return 2.0 * b * kp * n * w * c * (h + n)


def match_flops(b: int, n: int, n_gt: int, full: bool) -> float:
    """The Pallas matcher's charge (pallas_match.py:_kernel): with `full`,
    the one-hot contraction [Ip, 8] x [Ip, TN] -> [8, TN] in each of the
    B x Np / TN grid cells; without, no dot_general."""
    if not full:
        return 0.0
    ip = -(-max(n_gt, 1) // 8) * 8
    tn = max(512, min(4096, (1 << 22) // ip))
    np_ = -(-n // tn) * tn
    return 2.0 * 8 * ip * np_ * b
