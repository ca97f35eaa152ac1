"""The port's packed split vs the JAX package's, on the CPU: the mask
target extraction (crop_resize_matrices, extract_mask_targets), the
PackedDataset arrays of the same tiled split, its gather and batches,
its cache, and the device-resident split built from it."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.data.dataset import PackedDataset as JaxPacked
from livecell_tpu.data.dataset import pad_image_batch as j_pad_image_batch
from livecell_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from livecell_tpu.data.tiling import LIVECellPreprocessor
from livecell_tpu.ops.interp import crop_resize_matrices as j_crop_resize
from livecell_tpu.ops.mask_ops import extract_mask_targets as j_extract
from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.data import dataset as ds_mod
from livecell_tpu_torch.data.dataset import (
    PackedDataset, get_datasets, pad_image_batch)
from livecell_tpu_torch.data.device_data import DeviceDataset
from livecell_tpu_torch.ops.interp import _int_trunc, crop_resize_matrices
from livecell_tpu_torch.ops.mask_ops import extract_mask_targets
from tests.util_fakedata import make_fake_livecell

KW = dict(max_instances=48)


def edge_boxes(rng, k, h, w):
    """Boxes inside, across and outside the mask, inverted, thinner than a
    pixel, with negative corners that truncation (not floor) clamps."""
    b = rng.uniform(-12, max(h, w) + 12, (k, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(-6, 40, (k, 2))
    b[:4] = [[-0.7, -0.2, 5.5, 6.9], [-3.5, 2.0, -0.5, 8.0],
             [w - 0.3, h - 0.9, w + 4.0, h + 3.0], [2.2, 3.3, 2.9, 3.4]]
    return b


def test_int_trunc_truncates_toward_zero():
    x = torch.tensor([-1.7, -0.5, -0.0, 0.5, 1.7, 2.0])
    assert _int_trunc(x).tolist() == [-1.0, -0.0, -0.0, 0.0, 1.0, 2.0]
    assert _int_trunc(x).tolist() == x.int().float().tolist()


def test_crop_resize_matrices_match_jax(rng):
    h, w = 37, 53
    b = edge_boxes(rng, 64, h, w)
    wy, wx = crop_resize_matrices(torch.from_numpy(b), (h, w), 28)
    jy, jx = j_crop_resize(jnp.asarray(b), (h, w), 28)
    # Elementwise f32 arithmetic in the same order, the span divided (not
    # multiplied by a reciprocal): 1e-6, measured 0 (equal).
    np.testing.assert_allclose(wy.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(wy.numpy(), np.asarray(jy))


def test_extract_mask_targets_match_jax(rng):
    h, w, k = 74, 100, 48
    b = edge_boxes(rng, k, h, w)
    m = (rng.uniform(size=(k, h, w)) > 0.5).astype(np.uint8)
    got = extract_mask_targets(torch.from_numpy(m), torch.from_numpy(b)
                               ).numpy()
    jy, jx = map(lambda a: np.asarray(a, np.float64),
                 j_crop_resize(jnp.asarray(b), (h, w), 28))
    exact = np.einsum("kxw,kyw->kyx", jx,
                      np.einsum("kyh,khw->kyw", jy, m.astype(np.float64)))
    # The port's products are true f32: 1e-6 of the float64 result
    # (measured 6e-8).
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda a, c: j_extract(a, c, 28))(
            jnp.asarray(m), jnp.asarray(b)))
    # JAX's CPU dot in this build is not true f32 even at "highest"
    # (3.1e-5 from the float64 result at 222x300, 7.6e-6 here): 1e-4.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_pad_image_batch_matches_jax(rng):
    x = rng.integers(0, 256, (2, 10, 12, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pad_image_batch(x, (16, 20)),
                                  j_pad_image_batch(x, (16, 20)))


# ---------------------------------------------------------------------------
# The packed split.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A tiled split at LIVECell statistics (2/1/1 frames), tiled by the
    JAX tiler: both packages pack the same files."""
    src = make_fake_livecell(tmp_path_factory.mktemp("src"),
                             images_per_split=(2, 1, 1), stats="livecell",
                             mean_instances=150, seed=5)
    out = tmp_path_factory.mktemp("split")
    LIVECellPreprocessor(str(src), str(out), total_images=7).preprocess()
    return out


@pytest.fixture(scope="module")
def packed(split):
    jax_ds = JaxPacked(str(split), "train", JaxModelConfig(**KW), cache=False)
    port_ds = PackedDataset(str(split), "train", ModelConfig(**KW),
                            cache=False, device="cpu")
    return jax_ds, port_ds


def test_packed_split_matches_jax(packed):
    jds, pds = packed
    assert len(pds) == 50 and pds.tile_hw == (222, 300)
    for k in ("images", "boxes", "labels", "offsets", "image_ids"):
        got, want = getattr(pds, k), getattr(jds, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert pds.file_names == [str(n) for n in jds.file_names]
    assert pds.mask28.dtype == np.uint8 and pds.mask28.shape == \
        jds.mask28.shape
    assert len(pds.boxes) > 1000
    diff = np.abs(pds.mask28.astype(np.int16) - jds.mask28.astype(np.int16))
    # JAX's f32 products on the CPU carry up to 3e-5 of error (see
    # test_extract_mask_targets_match_jax), so a target on a rounding
    # boundary moves by one count of 1/255: bound 1 count, on at most
    # 0.1% of the entries (measured: 53 of 1,060,752 entries, 5.0e-5,
    # on this 50-tile split of 1,353 instances).
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_gather_and_batches_match_jax(packed):
    jds, pds = packed
    idx = np.array([3, 0, 17, 49, 3])
    gi, gt = pds.gather(idx)
    ji, jt = jds.gather(idx)
    np.testing.assert_array_equal(gi, ji)
    for k in jt:
        if k == "mask28":
            assert np.abs(gt[k].astype(int) - jt[k].astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(gt[k], jt[k], err_msg=k)
    got = list(pds.batches(16, shuffle=True, seed=3))
    want = list(jds.batches(16, shuffle=True, seed=3))
    assert len(got) == len(want) == 4
    for (a, ta, va), (b, tb, vb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ta["boxes"], tb["boxes"])
    assert got[-1][2].sum() == 50 - 48 and not got[-1][2][2:].any()
    for kw in (dict(drop_last=True), dict(pad_final=False)):
        assert [len(v) for _, _, v in pds.batches(16, **kw)] == \
            [len(v) for _, _, v in jds.batches(16, **kw)]


def test_truncation_at_max_instances_matches_jax(split):
    jds = JaxPacked(str(split), "train", JaxModelConfig(max_instances=8),
                    cache=False)
    pds = PackedDataset(str(split), "train", ModelConfig(max_instances=8),
                        cache=False, device="cpu")
    assert pds.instance_counts().max() > 8
    for ds in (pds, jds):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            images, t = ds.gather(np.arange(len(ds)))
            ds.gather(np.arange(len(ds)))
        assert len(w) == 1 and "max_instances=8" in str(w[0].message)
        assert t["valid"].sum(1).max() == 8
    np.testing.assert_array_equal(pds.gather([0, 1])[1]["boxes"],
                                  jds.gather([0, 1])[1]["boxes"])


def test_device_dataset_from_packed_matches_jax(packed):
    jds, pds = packed
    jdd = JaxDeviceDataset(jds)
    dd = DeviceDataset.from_packed(pds, device="cpu")
    assert len(dd) == len(jdd) == 50
    assert dd.nbytes == jdd.nbytes
    np.testing.assert_array_equal(dd.images.numpy(), np.asarray(jdd.images))
    for k, v in jdd.targets.items():
        got = dd.targets[k].numpy()
        if k == "mask28":
            assert np.abs(got.astype(int) - np.asarray(v).astype(int)
                          ).max() <= 1
        else:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    images, targets = dd.batch(torch.tensor([4, 1]))
    np.testing.assert_array_equal(images.numpy(), pds.gather([4, 1])[0])


def test_cache_is_the_ports_own(split, monkeypatch):
    """The port caches under .livecell_tpu_torch_cache with the device
    type in its key, never opens the JAX package's .livecell_tpu_cache,
    and reloads what it wrote."""
    JaxPacked(str(split), "test", JaxModelConfig(**KW))   # JAX's cache
    assert list((split / ".livecell_tpu_cache").glob("test_*.npz"))
    opened = []
    real_load = np.load

    def spy(path, *a, **k):
        opened.append(str(path))
        return real_load(path, *a, **k)

    monkeypatch.setattr(ds_mod.np, "load", spy)
    first = PackedDataset(str(split), "test", ModelConfig(**KW), device="cpu")
    assert opened == []
    path = first._cache_path()
    assert path.parent == split / ".livecell_tpu_torch_cache" and path.exists()
    again = PackedDataset(str(split), "test", ModelConfig(**KW), device="cpu")
    assert opened == [str(path)]
    for k in ("images", "boxes", "labels", "mask28", "offsets", "image_ids"):
        np.testing.assert_array_equal(getattr(again, k), getattr(first, k))
    assert again.file_names == first.file_names
    first.device = torch.device("cuda")
    assert first._cache_path() != path


def test_get_datasets_loads_every_split(split):
    got = get_datasets(str(split), ModelConfig(**KW), device="cpu")
    assert {k: len(v) for k, v in got.items()} == {
        "train": 50, "val": 25, "test": 25}
