"""Seeded weights for a model's state dict, made on the device in a few
large calls: one normal and one uniform draw for all leaves, scaled
leaf by leaf in one multi-tensor multiply. Which distribution a leaf
takes is data: the configuration file's `init` rules, each [regex,
rule, argument], the first match winning:

  normal_fan_out  N(0, 2 / fan_out)            (kaiming_normal, fan_out)
  uniform_fan_in  U(+-1 / sqrt(fan_in))         (torch's Conv/Linear default;
                                                 a bias takes its weight's fan)
  uniform_a1      U(+-sqrt(3 / fan_in))         (kaiming_uniform, a=1)
  normal          N(0, argument^2)
  zeros, ones
  constant        the argument: a number, or a list of one a row

Fans follow PyTorch's weight layout [out, in, k...]: fan_in = in * k,
fan_out = out * k."""

from __future__ import annotations

import math
import re
from typing import Dict, List

import torch


def _fan(shape, which: str) -> int:
    k = math.prod(shape[2:]) if len(shape) > 2 else 1
    return (shape[1] if which == "in" else shape[0]) * k


def rules_of(spec: Dict) -> List[list]:
    """A cell's rules: its traffic's `init` (what a served or trained
    model's state needs beyond the initializers) before its
    configuration's."""
    return spec["traffic"].get("init", []) + spec["config"]["init"]


def make(shapes: Dict[str, tuple], rules: List[list], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 (or int64 for counters) tensor} for `shapes`
    ({name: (shape, dtype)}) under `rules`, drawn from `seed` on
    `device`. Raises for a leaf no rule matches."""
    compiled = [(re.compile(r), kind, arg) for r, kind, *rest in rules
                for arg in [rest[0] if rest else None]]
    plan = {}
    for name, (shape, dtype) in shapes.items():
        hit = next(((k, a) for r, k, a in compiled if r.search(name)), None)
        if hit is None:
            raise KeyError(f"no init rule matches {name}")
        plan[name] = hit
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {"normal": 0, "uniform": 0}
    for name, (kind, _) in plan.items():
        n = math.prod(shapes[name][0])
        if kind in ("normal_fan_out", "normal"):
            sizes["normal"] += n
        elif kind in ("uniform_fan_in", "uniform_a1"):
            sizes["uniform"] += n
    z = torch.randn(sizes["normal"], generator=gen, device=device)
    u = torch.rand(sizes["uniform"], generator=gen, device=device) \
        .mul_(2.0).sub_(1.0)
    out, views, scales = {}, [], []
    at = {"normal": 0, "uniform": 0}
    for name, (kind, arg) in plan.items():
        shape, dtype = shapes[name]
        n = math.prod(shape)
        if kind in ("zeros", "ones"):
            out[name] = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, dtype=dtype, device=device)
            continue
        if kind == "constant":
            value = torch.as_tensor(arg, dtype=dtype, device=device)
            out[name] = value.reshape(value.shape + (1,) * (
                len(shape) - value.dim())).expand(shape).clone()
            continue
        pool = "normal" if kind in ("normal_fan_out", "normal") \
            else "uniform"
        src = z if pool == "normal" else u
        view = src[at[pool]:at[pool] + n].view(shape)
        at[pool] += n
        wshape = shapes[name[:-len("bias")] + "weight"][0] \
            if name.endswith("bias") else shape
        if kind == "normal_fan_out":
            scale = math.sqrt(2.0 / _fan(wshape, "out"))
        elif kind == "uniform_fan_in":
            scale = 1.0 / math.sqrt(_fan(wshape, "in"))
        elif kind == "uniform_a1":
            scale = math.sqrt(3.0 / _fan(wshape, "in"))
        else:
            scale = float(arg)
        out[name] = view
        views.append(view)
        scales.append(scale)
    torch._foreach_mul_(views, scales)
    return out


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    return {k: (tuple(v.shape), v.dtype if not v.is_floating_point()
                else torch.float32)
            for k, v in model.state_dict().items()}
