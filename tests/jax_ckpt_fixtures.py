"""Checkpoints written by the JAX package, for the port's reader on the
card (chip_smoke.py's phase 22), and what JAX computes from them.

    python -m tests.jax_ckpt_fixtures [OUT]     (default tests/fixtures/jax_ckpt)
    python -m tests.jax_ckpt_fixtures --full DIR

writes, through the JAX package's own train/checkpoint.py:save,

  custom/     the custom trainer's full save (train_custom.py:437-442):
              params, batch_stats, optax adamw state after two steps
              (counts 2), epoch 2, train_losses, val_metrics, param_info
              and the model_config.json sidecar (CUSTOM_CFG: the
              published widths at a 64x96 input, f32);
  transfer/   the transfer trainer's bare save (train_transfer.py:
              316-319): params and batch_stats, no sidecar;
  leaves.json each leaf's shape, dtype and SHA-256, per directory;
  tile_custom.npy, tile_transfer.npy
              one seeded uint8 tile each (CUSTOM_CFG's input, the
              transfer model's 224x304 input tile);
  outputs.json
              JAX's inference forward of each on its tile on the CPU (the
              custom model at its sidecar's config, the transfer model at
              TransferConfig() in f32): the valid detections' boxes,
              scores and mask-probability sums.

Both models have their published widths (31.0 M and 44.0 M
parameters). Random weights at those widths take 113 MB and 176 MB, so
each leaf holds a seeded normal pattern of PERIOD values repeated over
its length, at the scale of an initialized layer: zstd keeps one period
and the repeats cost a few bytes, and the fixtures stay near 1.5 MB.
The values come from numpy alone, so a regeneration writes the same
leaves on any machine (tests/test_torch_jax_fixtures.py checks the
committed hashes against one).

`--full DIR` writes a full-width ModelConfig() checkpoint of JAX's
initialized (random) weights instead, 113 MB, for timing the reader
(livecell_tpu_torch/tools/bench_ckpt_read.py) where it cannot live in
the tree.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

PERIOD = 509
TOP_K, MIN_GAP = 20, 1e-4
OUT = Path(__file__).resolve().parent / "fixtures" / "jax_ckpt"
CUSTOM_KW = dict(image_height=64, image_width=96, compute_dtype="float32",
                 roi_precision="highest", roi_backend="einsum",
                 infer_pre_topk=64, infer_post_nms=16, max_detections=16,
                 det_score_thresh=0.3, heads_all_images=True,
                 decode_proposals=True, mask_train_samples=16)
# Score spread of the heads (as tests/util_torch_port.py and
# tests/test_torch_transfer.py scale their predictors).
CUSTOM_SCALE = {"rpn/cls_logits/kernel": 30.0,
                "box_head/cls_score/kernel": 10.0,
                "mask_head/mask_fcn_logits/kernel": 30.0}
TRANSFER_SCALE = {"rpn/cls_logits/kernel": 0.5,
                  "box_predictor/cls_score/kernel": 1.0,
                  "box_predictor/bbox_pred/kernel": 3.0,
                  "mask_head/mask_fcn_logits/kernel": 0.3}


def custom_cfg():
    from livecell_tpu.config import ModelConfig

    return ModelConfig(**CUSTOM_KW)


def transfer_cfg():
    import dataclasses

    from livecell_tpu.models.transfer import TransferConfig

    return dataclasses.replace(TransferConfig(), compute_dtype="float32",
                               roi_backend="xla", rpn_match_backend="xla")


def _pattern(shape, scale, seed, offset=0.0, absolute=False):
    """offset + scale * a seeded standard normal pattern of PERIOD values
    (of zero mean: a kernel sums whole periods over a constant input, and
    a pattern's mean would grow with the number of them), repeated."""
    base = np.random.default_rng(seed).standard_normal(PERIOD)
    base = np.abs(base) if absolute else base - base.mean()
    base = (offset + scale * base).astype(np.float32)
    return np.resize(base, int(np.prod(shape))).reshape(shape)


def _fill(shapes, scales, seed, kind="params"):
    """A tree of patterns over the shapes tree (nested dicts)."""
    out = {}
    for i, (k, v) in enumerate(sorted(shapes.items())):
        if isinstance(v, dict):
            out[k] = _fill(v, {n[len(k) + 1:]: s for n, s in scales.items()
                               if n.startswith(k + "/")},
                           seed * 131 + i + 1, kind)
            continue
        shape, s = v.shape, seed * 131 + i + 1
        if kind == "stats":
            out[k] = _pattern(shape, 0.05, s, 1.0, True) if k == "var" else \
                _pattern(shape, 0.05, s)
        elif k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            out[k] = _pattern(shape, scales.get(k, 1.0) / np.sqrt(fan_in), s)
        elif k == "scale":
            out[k] = _pattern(shape, 0.05, s, 1.0)
        else:
            out[k] = _pattern(shape, 0.02, s)
    return out


def _shapes(init):
    import jax

    return jax.tree.map(lambda x: x, jax.eval_shape(init))


def custom_variables():
    import jax

    from livecell_tpu.models.mask_rcnn import create_model

    shapes = _shapes(lambda: create_model(custom_cfg(), jax.random.key(0))[1])
    return {"params": _fill(shapes["params"], CUSTOM_SCALE, 1),
            "batch_stats": _fill(shapes["batch_stats"], {}, 2, "stats")}


def transfer_variables():
    import jax

    from livecell_tpu.models.transfer import create_transfer_model

    shapes = _shapes(lambda: create_transfer_model(
        rng=jax.random.key(0), cfg=transfer_cfg())[1])
    return {"params": _fill(shapes["params"], TRANSFER_SCALE, 3),
            "batch_stats": _fill(shapes["batch_stats"], {}, 4, "stats")}


def custom_opt_state(params):
    """optax.adamw's state after two steps, as its tree holds it: counts
    2, first moments ~1e-3, second moments ~1e-6 (positive)."""
    import optax

    from livecell_tpu.train.train_custom import build_optimizer

    tx, _ = build_optimizer(1e-3, 1e-4, 1, 1, 0.1)
    ref = tx.init(params)
    mu = _fill(params, {}, 5)
    nu = _fill(params, {}, 6)
    mu = {k: _scaled(v, 1e-3) for k, v in mu.items()}
    nu = {k: _scaled(v, 1e-6, square=True) for k, v in nu.items()}
    adam = ref[0]._replace(count=np.asarray(2, np.int32), mu=mu, nu=nu)
    sched = ref[2]._replace(count=np.asarray(2, np.int32))
    assert isinstance(ref[1], optax.EmptyState)
    return (adam, ref[1], sched)


def _scaled(tree, s, square=False):
    if isinstance(tree, dict):
        return {k: _scaled(v, s, square) for k, v in tree.items()}
    return ((tree * tree if square else tree) * np.float32(s)).astype(
        np.float32)


def leaf_table(payload) -> dict:
    """{leaf path: {shape, dtype, sha256}} of a loaded checkpoint's
    arrays (scalars and None leaves are left out)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, np.ndarray):
            a = np.ascontiguousarray(node)
            out[path] = {"shape": list(a.shape), "dtype": a.dtype.str,
                         "sha256": hashlib.sha256(a.tobytes()).hexdigest()}

    walk({k: v for k, v in payload.items() if k != "model_config"}, "")
    return out


def write_checkpoints(out: Path) -> dict:
    """Write custom/ and transfer/ under `out` with the JAX package;
    returns {name: leaf table} as JAX's load reads them back."""
    from livecell_tpu.config import model_config_to_dict
    from livecell_tpu.models.mask_rcnn import count_parameters
    from livecell_tpu.train import checkpoint

    out.mkdir(parents=True, exist_ok=True)
    cv = custom_variables()
    checkpoint.save(str(out / "custom"), cv["params"], cv["batch_stats"],
                    opt_state=custom_opt_state(cv["params"]), epoch=2,
                    train_losses=[2.5, 1.75],
                    val_metrics=[{"mean_iou": 0.25, "mean_precision": 0.5,
                                  "mean_recall": 0.125, "f1_score": 0.2},
                                 {"mean_iou": 0.375, "mean_precision": 0.5,
                                  "mean_recall": 0.25, "f1_score": 0.3125}],
                    param_info=count_parameters(cv["params"]),
                    model_config=model_config_to_dict(custom_cfg()))
    tv = transfer_variables()
    checkpoint.save(str(out / "transfer"), tv["params"], tv["batch_stats"])
    return {name: leaf_table(checkpoint.load(str(out / name)))
            for name in ("custom", "transfer")}


def tiles():
    """The seeded tiles: uniform noise with bright discs, uint8 RGB."""
    ccfg, tcfg = custom_cfg(), transfer_cfg()
    out = {}
    for name, (h, w), seed in (
            ("custom", (ccfg.image_height, ccfg.image_width), 11),
            ("transfer", (tcfg.tile_height, tcfg.tile_width), 12)):
        rng = np.random.default_rng(seed)
        img = rng.uniform(0, 160, (h, w, 3))
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(10):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(4, max(h, w) / 10)
            img += 90 * ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)[..., None]
        out[name] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def jax_outputs(out: Path, imgs) -> dict:
    """JAX's inference forward of each checkpoint on its tile (/ 255, f32
    at "highest" matmul precision): the valid detections' boxes, scores
    and mask-probability sums, in the model's order. TOP_K detections are
    compared on the card; their scores (and the next one's) lie more
    than MIN_GAP apart."""
    import jax
    import jax.numpy as jnp

    from livecell_tpu.models.mask_rcnn import CustomMaskRCNN
    from livecell_tpu.models.transfer import TransferMaskRCNN
    from livecell_tpu.train import checkpoint

    result = {}
    for name, model in (("custom", CustomMaskRCNN(custom_cfg())),
                        ("transfer", TransferMaskRCNN(transfer_cfg()))):
        ckpt = checkpoint.load(str(out / name))
        v = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
        x = jnp.asarray(imgs[name][None].astype(np.float32) / 255.0)
        with jax.default_matmul_precision("highest"):
            det = jax.tree.map(np.asarray, jax.jit(
                lambda v, x: model.apply(v, x, train=False))(v, x))
        k = det.valid[0]
        scores = det.scores[0][k]
        top = np.sort(scores)[::-1][:TOP_K + 1]
        assert len(top) >= 3 and np.diff(top[::-1]).min() > MIN_GAP, top
        result[name] = {
            "boxes": det.boxes[0][k].tolist(), "scores": scores.tolist(),
            "mask_prob_sums": det.mask_probs[0][k].reshape(
                len(scores), -1).sum(1).tolist()}
    return result


def write_full_width(out: Path) -> None:
    """A full-width ModelConfig() checkpoint as the JAX package writes
    one without optimizer state (JAX's initialized weights, seed 0, and
    the sidecar: 113 MB), for tools/bench_ckpt_read.py."""
    import jax

    from livecell_tpu.config import ModelConfig, model_config_to_dict
    from livecell_tpu.models.mask_rcnn import create_model
    from livecell_tpu.train import checkpoint

    cfg = ModelConfig()
    _, v = create_model(cfg, jax.random.key(0))
    v = jax.tree.map(np.asarray, v)
    checkpoint.save(str(out), v["params"], v["batch_stats"],
                    model_config=model_config_to_dict(cfg))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--full"]:
        write_full_width(Path(argv[1]))
        return
    out = Path(argv[0]) if argv else OUT
    if out.exists():
        shutil.rmtree(out)
    tables = write_checkpoints(out)
    (out / "leaves.json").write_text(json.dumps(tables, indent=1,
                                                sort_keys=True))
    imgs = tiles()
    for name, img in imgs.items():
        np.save(out / f"tile_{name}.npy", img)
    (out / "outputs.json").write_text(json.dumps(jax_outputs(out, imgs),
                                                 indent=1))
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: {size / 2**20:.2f} MiB")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
