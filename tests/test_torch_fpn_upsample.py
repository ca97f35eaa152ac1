"""The FPN's top-down upsample-and-add (models/fpn.py): `upsample_add`,
a broadcast add over NHWC, against the indexed path
`lat + nearest_upsample_to(top, ...)` it replaces, on every level step
of both models and on a shape whose map is not i // r.

The forward must be equal bit for bit (nearest neighbour copies values;
the add is the same add). The backward may sum the <= 4 gradient terms
of a source pixel in another order: f32 within rtol 1e-6; bf16 within
one bf16 ulp of the sum of the terms' magnitudes (the indexed path
rounds after each axis, the broadcast sum once, so an element whose
terms cancel cannot be held to an ulp of itself).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from livecell_tpu_torch.models import fpn as fpn_mod
from livecell_tpu_torch.models.fpn import (
    FPN, nearest_upsample_to, repeat_factor, upsample_add)
from livecell_tpu_torch.models.transfer import pyramid_shapes

# P2-P5 of each model: the custom model's 224x304 tile and the transfer
# model's 800x1088 canvas (both trunks take ceil(n/2) at each stride).
CUSTOM = pyramid_shapes(224, 304)[:4]
TRANSFER = pyramid_shapes(800, 1088)[:4]
STEPS = [(CUSTOM[i + 1], CUSTOM[i]) for i in range(3)] + [
    (TRANSFER[i + 1], TRANSFER[i]) for i in range(3)]
FALLBACK = ((5, 7), (13, 16))
C = 8


def test_level_shapes():
    assert CUSTOM == ((56, 76), (28, 38), (14, 19), (7, 10))
    assert TRANSFER == ((200, 272), (100, 136), (50, 68), (25, 34))


@pytest.mark.parametrize("src,dst,r", [
    (7, 14, 2), (10, 19, 2), (19, 38, 2), (136, 272, 2), (10, 10, 1),
    (4, 7, 2), (5, 13, None), (7, 16, None), (10, 5, None)])
def test_repeat_factor(src, dst, r):
    assert repeat_factor(src, dst) == r
    if r is not None:
        assert all((i * src) // dst == i // r for i in range(dst))


def _inputs(top_hw, lat_hw, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    top, lat, grad = (torch.randn(2, C, *hw, generator=g).to(dtype)
                      for hw in (top_hw, lat_hw, lat_hw))
    if channels_last:
        top, lat, grad = (t.contiguous(memory_format=torch.channels_last)
                          for t in (top, lat, grad))
    return top, lat, grad


def _run(fn, top, lat, grad):
    top = top.clone().requires_grad_()
    lat = lat.clone().requires_grad_()
    out = fn(lat, top)
    out.backward(grad)
    return out.detach(), top.grad, lat.grad


def _indexed(lat, top):
    return lat + nearest_upsample_to(top, lat.shape[2:])


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("channels_last", [True, False],
                         ids=["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("top_hw,lat_hw", STEPS + [FALLBACK],
                         ids=lambda hw: "x".join(map(str, hw)))
def test_upsample_add_matches_indexed(top_hw, lat_hw, dtype, channels_last):
    top, lat, grad = _inputs(top_hw, lat_hw, dtype, channels_last)
    if (top_hw, lat_hw) == FALLBACK:
        assert upsample_add(lat, top) is None
        return
    out, g_top, g_lat = _run(upsample_add, top, lat, grad)
    ref, r_top, r_lat = _run(_indexed, top, lat, grad)
    assert out.dtype == dtype and torch.equal(out, ref)
    if channels_last:
        assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(g_lat, r_lat)
    if dtype == torch.float32:
        torch.testing.assert_close(g_top, r_top, rtol=1e-6, atol=0)
        return
    # The sum of the magnitudes of each source pixel's terms, exactly.
    mag = top.double().requires_grad_()
    (nearest_upsample_to(mag, lat_hw) * grad.double().abs()).sum().backward()
    gap = (g_top.double() - r_top.double()).abs()
    assert (gap <= _bf16_ulp(mag.grad)).all()


def _pyramid(shapes, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(1, 4 * (i + 1), *hw, generator=g).to(dtype)
             for i, hw in enumerate(shapes)]
    if channels_last:
        feats = [f.contiguous(memory_format=torch.channels_last)
                 for f in feats]
    return feats


def _fpn(model, dtype, channels_last, levels=4):
    """Each model's FPN, at C channels (the lateral widths 4, 8, 12, ...
    stand in for the trunks')."""
    kw = {} if model == "custom" else dict(relu_outputs=False,
                                           extra_maxpool=True)
    fpn = FPN(tuple(4 * (i + 1) for i in range(levels)), C,
              torch.Generator().manual_seed(1), **kw)
    fpn = fpn.to(dtype)
    if channels_last:
        fpn = fpn.to(memory_format=torch.channels_last)
    return fpn


@pytest.mark.parametrize("model,shapes,want", [
    ("custom", CUSTOM, {"repeat": 3, "indexed": 0}),
    ("transfer", TRANSFER, {"repeat": 3, "indexed": 0}),
    ("custom", FALLBACK[::-1], {"repeat": 0, "indexed": 1}),
    ("custom", ((13, 16), FALLBACK[0], (3, 4), (2, 2)),
     {"repeat": 2, "indexed": 1}),
], ids=["custom", "transfer", "fallback", "mixed"])
def test_fpn_counts_paths(model, shapes, want):
    fpn = _fpn(model, torch.float32, True, levels=len(shapes))
    with torch.no_grad():
        fpn(_pyramid(shapes, torch.float32, True))
    assert fpn.stats == want
    with torch.no_grad():
        fpn(_pyramid(shapes, torch.float32, True))
    assert fpn.stats == {k: 2 * v for k, v in want.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("model", ["custom", "transfer"])
def test_fpn_outputs_equal_indexed_path(model, dtype, monkeypatch):
    """Both models' FPN outputs, with every level on the broadcast path,
    equal bit for bit those of the indexed path on every level (the FPN
    as it was before `upsample_add`), and so do the weights' and inputs'
    gradients in f32 within 1e-6."""
    shapes = CUSTOM if model == "custom" else TRANSFER
    fpn = _fpn(model, dtype, True)
    feats = _pyramid(shapes, dtype, True)

    def run():
        xs = [f.clone().requires_grad_() for f in feats]
        fpn.zero_grad()
        outs = fpn(xs)
        sum((o.float() * (k + 1)).sum() for k, o in enumerate(outs)) \
            .backward()
        grads = [x.grad for x in xs] + [p.grad.clone()
                                        for p in fpn.parameters()]
        return [o.detach() for o in outs], grads

    outs, grads = run()
    assert fpn.stats == {"repeat": 3, "indexed": 0}
    monkeypatch.setattr(fpn_mod, "upsample_add", lambda lat, top: None)
    ref_outs, ref_grads = run()
    assert fpn.stats == {"repeat": 3, "indexed": 3}
    assert len(outs) == len(ref_outs)
    for o, r in zip(outs, ref_outs):
        assert torch.equal(o, r)
    if dtype == torch.float32:
        for g, r in zip(grads, ref_grads):
            torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_hw,lat_hw", [STEPS[0], STEPS[3]],
                         ids=["custom-crop", "transfer"])
def test_repeat_backward_has_no_index_put_or_sort(top_hw, lat_hw):
    top, lat, grad = _inputs(top_hw, lat_hw, torch.bfloat16, True)

    def ops(fn):
        t = top.clone().requires_grad_()
        out = fn(lat, t)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out.backward(grad)
        return {e.key for e in prof.key_averages()}

    # The indexed path's backward is IndexBackward0 -> index_put_ (on
    # the CPU its _impl_, on the card a sort inside it): the profiler
    # sees it.
    assert {"IndexBackward0", "aten::_index_put_impl_"} <= ops(_indexed)
    names = ops(upsample_add)
    assert not names & {"IndexBackward0", "aten::index_put_",
                        "aten::_index_put_impl_", "aten::sort"}
    assert "aten::sum" in names
