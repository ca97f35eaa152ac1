"""Checkpoints the JAX package writes, read without JAX, Orbax or
tensorstore (the read half of livecell_tpu/train/checkpoint.py).

The JAX package saves through Orbax's StandardCheckpointer a directory
that holds

  _METADATA           JSON: use_ocdbt, use_zarr3 and `tree_metadata`,
                      each leaf's key path (with the `key_type` of each
                      key: 1 a sequence index, 2 a dict key) and its
                      value type (np.ndarray, scalar, None, Dict, List);
  manifest.ocdbt, d/, ocdbt.process_<i>/
                      the OCDBT key-value store (utils/ocdbt.py) with one
                      zarr v2 array (utils/zarr_v2.py) per leaf, under
                      the leaf's key path joined by "." (`<name>/.zarray`,
                      `<name>/<chunk>`), each chunk a zstd frame;
  model_config.json   the model's config (custom trainer only).

`load(path)` returns what JAX's `checkpoint.load` returns: `params`,
`batch_stats` (default {}), `opt_state` where saved (optax's adamw
state as Orbax restores it: [{count, mu, nu}, None, {count}]), `meta`
(default {}) and `model_config` from the sidecar; a bare variables tree
(no `params` key) becomes the params. Arrays come back as numpy arrays
of the stored dtype ("bfloat16" widened to float32), scalar leaves as
Python numbers. The layout Orbax writes with OCDBT off (one directory of
zarr files a leaf) is read too. What the reader refuses raises a
ValueError naming it: UnsupportedCheckpoint (zarr v3, an unknown value
or key type), or the layer's own (OcdbtError, UnsupportedArray,
ZstdError); no partial tree is returned.

`model_state(path, model_type)` carries the payload into the port:
the state dict through models/convert.py:from_jax_variables and the
config from the sidecar (config.py:config_from_dict). A checkpoint
without a sidecar (the transfer trainer's bare save) is typed from the
caller's `model_type` or else from keys only one model's tree has; a
type that disagrees with the keys raises. `adamw_state` maps optax's
moments onto the port's AdamW (parallel/train_step.py:build_optimizer).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from livecell_tpu_torch.utils import ocdbt, zarr_v2

METADATA = "_METADATA"
SIDECAR = "model_config.json"
SEQUENCE, DICT = 1, 2


class UnsupportedCheckpoint(ValueError):
    """A JAX checkpoint in a layout the reader refuses (named in the
    message)."""


def is_jax_checkpoint(path) -> bool:
    """Whether `path` is a directory Orbax wrote (its _METADATA)."""
    return (Path(path) / METADATA).is_file()


class _FileStore:
    """The layout Orbax writes with OCDBT off: `<name>/.zarray` and
    `<name>/<chunk>` as files under the checkpoint directory."""

    def __init__(self, root: Path):
        self.root = root
        self.bytes_read = 0

    def get(self, key: bytes) -> Optional[bytes]:
        path = self.root / key.decode()
        if not path.is_file():
            return None
        data = path.read_bytes()
        self.bytes_read += len(data)
        return data


def _store(path: Path, meta: Dict):
    if meta.get("use_zarr3"):
        raise UnsupportedCheckpoint(f"{path}: zarr v3 arrays (use_zarr3) "
                                    f"are not supported, only zarr v2")
    if meta.get("use_ocdbt", False):
        store = ocdbt.open_store(path)
        keys = set(store.keys())
        return store, lambda k: store.get(k) if k in keys else None
    store = _FileStore(path)
    return store, store.get


def _leaf(value_type: str, name: str, get, stats: Dict):
    if value_type in ("None", "Dict", "List"):
        return {"None": None, "Dict": {}, "List": []}[value_type]
    if value_type not in ("np.ndarray", "jax.Array", "scalar"):
        raise UnsupportedCheckpoint(f"leaf {name}: value type "
                                    f"{value_type!r}")
    t = time.perf_counter()
    zarray = get(f"{name}/.zarray".encode())
    stats["ocdbt_s"] += time.perf_counter() - t
    if zarray is None:
        if get(f"{name}/zarr.json".encode()) is not None:
            raise UnsupportedCheckpoint(f"leaf {name}: zarr v3 array")
        raise UnsupportedCheckpoint(f"leaf {name}: no .zarray in the "
                                    f"checkpoint")

    def chunk(key: str):
        t0 = time.perf_counter()
        data = get(f"{name}/{key}".encode())
        stats["ocdbt_s"] += time.perf_counter() - t0
        return data

    arr = zarr_v2.read_array(json.loads(zarray), chunk, f"leaf {name}",
                             stats)
    return arr.item() if value_type == "scalar" else arr


def _build(entries):
    """Nested dicts and lists from (keys [(key, key_type)], value): the
    children of a node are a dict's keys or a sequence's indices
    0..n-1, never both."""
    tree: Dict = {}
    for keys, value in entries:
        node = tree
        for k, kt in keys[:-1]:
            node = node.setdefault((k, kt), {})
            if isinstance(node, _Leaf):
                raise UnsupportedCheckpoint(f"key {k!r} is a leaf and a "
                                            f"subtree")
        if keys[-1] in node:
            raise UnsupportedCheckpoint(f"key path {[k for k, _ in keys]} "
                                        f"twice")
        node[keys[-1]] = _Leaf(value)

    def convert(node):
        if isinstance(node, _Leaf):
            return node.value
        kinds = {kt for _, kt in node}
        if kinds == {DICT}:
            return {k: convert(v) for (k, _), v in node.items()}
        if kinds == {SEQUENCE}:
            items = sorted((int(k), v) for (k, _), v in node.items())
            if [i for i, _ in items] != list(range(len(items))):
                raise UnsupportedCheckpoint("sequence indices "
                                            f"{[i for i, _ in items]}")
            return [convert(v) for _, v in items]
        raise UnsupportedCheckpoint(f"key types {sorted(kinds)} in one node")

    return convert(tree) if tree else {}


class _Leaf:
    def __init__(self, value):
        self.value = value


def load(path, stats: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """JAX's checkpoint.load of `path`, without JAX. `stats`, where given,
    receives the seconds of each layer (`ocdbt_s`: manifest, nodes and
    reading the values; `zstd_s`: decompressing the chunks;
    `assembly_s`: the rest) and the bytes read (`bytes`, compressed) and
    decoded (`decoded_bytes`)."""
    t0 = time.perf_counter()
    path = Path(os.path.abspath(path))
    st = {"ocdbt_s": 0.0, "zstd_s": 0.0, "decoded_bytes": 0}
    meta_path = path / METADATA
    if not meta_path.is_file():
        raise FileNotFoundError(f"{path} holds no {METADATA} (not an Orbax "
                                f"checkpoint)")
    meta = json.loads(meta_path.read_text())
    if "tree_metadata" not in meta:
        raise UnsupportedCheckpoint(f"{meta_path}: no tree_metadata")
    t = time.perf_counter()
    store, get = _store(path, meta)
    st["ocdbt_s"] += time.perf_counter() - t
    entries = []
    for leaf in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
        name = ".".join(k for k, _ in keys)
        entries.append((keys, _leaf(leaf["value_metadata"]["value_type"],
                                    name, get, st)))
    payload = _build(entries)
    if not isinstance(payload, dict):
        raise UnsupportedCheckpoint(f"{path}: the tree's root is a "
                                    f"sequence")
    if "params" not in payload:
        payload = {"params": payload, "batch_stats": {}, "meta": {}}
    payload.setdefault("batch_stats", {})
    payload.setdefault("meta", {})
    sidecar = path / SIDECAR
    if sidecar.exists():
        payload["model_config"] = json.loads(sidecar.read_text())
    if stats is not None:
        total = time.perf_counter() - t0
        st["bytes"] = store.bytes_read
        st["assembly_s"] = total - st["ocdbt_s"] - st["zstd_s"]
        stats.update(st)
    return payload


# ---------------------------------------------------------------------------
# Into the port.
# ---------------------------------------------------------------------------

def tree_model_type(params: Dict) -> str:
    """"custom" or "transfer" from keys only one model's parameter tree
    has: the custom model's CBAM blocks, the transfer model's
    torchvision-style box predictor."""
    custom, transfer = "cbam1" in params, "box_predictor" in params
    if custom == transfer:
        raise UnsupportedCheckpoint(
            "the parameter tree is neither the custom nor the transfer "
            f"model's (top-level keys {sorted(params)})")
    return "custom" if custom else "transfer"


def payload_config(payload: Dict, model_type: Optional[str] = None
                   ) -> Tuple[str, Any]:
    """(model_type, config) of a loaded JAX checkpoint: the sidecar's
    config where there is one (a JAX sidecar is custom), else
    ModelConfig() or TransferConfig(), as the JAX entry points build them
    without one. Raises when `model_type`, the sidecar or the tree's keys
    disagree."""
    from livecell_tpu_torch.config import (
        MODEL_TYPES, ModelConfig, TransferConfig, config_from_dict)

    if model_type is not None and model_type not in MODEL_TYPES:
        raise ValueError(f"Unknown model_type: {model_type}")
    kind = tree_model_type(payload["params"])
    if model_type is not None and model_type != kind:
        raise ValueError(f"model_type {model_type!r}, but the checkpoint "
                         f"holds a {kind!r} model")
    if "model_config" in payload:
        stored, cfg = config_from_dict(payload["model_config"])
        if stored != kind:
            raise ValueError(f"the sidecar names a {stored!r} model, the "
                             f"parameters are a {kind!r} model's")
        return kind, cfg
    return kind, ModelConfig() if kind == "custom" else TransferConfig()


def model_state(path, device=None, model_type: Optional[str] = None,
                payload: Optional[Dict] = None
                ) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    """(model_type, config, state dict on `device`) of a JAX checkpoint
    directory (or of its already loaded `payload`)."""
    from livecell_tpu_torch.device import resolve_device
    from livecell_tpu_torch.models.convert import from_jax_variables

    if payload is None:
        payload = load(path)
    kind, cfg = payload_config(payload, model_type)
    sd = from_jax_variables({"params": payload["params"],
                             "batch_stats": payload["batch_stats"]})
    dev = resolve_device(device)
    return kind, cfg, {k: v.to(dev) for k, v in sd.items()}


def adamw_state(opt_state, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> Dict:
    """The port's AdamW state dict for `optimizer` (over `model`'s
    parameters) from optax.adamw(schedule)'s state as the JAX checkpoint
    holds it, [ScaleByAdamState(count, mu, nu), EmptyState (None),
    ScaleByScheduleState(count)] (livecell_tpu/train/train_custom.py:
    build_optimizer): `mu` and `nu` take the parameters' mapping (it is
    elementwise), Adam's count becomes each parameter's `step`, the
    schedule's count the group's `schedule_step`. The groups keep the
    optimizer's own settings (the caller's schedule)."""
    from livecell_tpu_torch.models.convert import from_jax_variables

    if not (isinstance(opt_state, list) and len(opt_state) == 3
            and isinstance(opt_state[0], dict)
            and set(opt_state[0]) == {"count", "mu", "nu"}
            and opt_state[1] is None and isinstance(opt_state[2], dict)
            and set(opt_state[2]) == {"count"}):
        raise UnsupportedCheckpoint(
            "opt_state is not optax.adamw(schedule)'s state "
            "[{count, mu, nu}, None, {count}]")
    mu = from_jax_variables({"params": opt_state[0]["mu"]})
    nu = from_jax_variables({"params": opt_state[0]["nu"]})
    count = int(np.asarray(opt_state[0]["count"]))
    schedule = int(np.asarray(opt_state[2]["count"]))
    names = {id(p): n for n, p in model.named_parameters()}
    state, groups, i = {}, [], 0
    for g in optimizer.param_groups:
        ids = []
        for p in g["params"]:
            name = names[id(p)]
            state[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].to(p.device),
                        "exp_avg_sq": nu[name].to(p.device)}
            ids.append(i)
            i += 1
        group = {k: v for k, v in g.items() if k != "params"}
        group["params"] = ids
        if "schedule_step" in group:
            group["schedule_step"] = schedule
        groups.append(group)
    if i != len(mu):
        raise UnsupportedCheckpoint(f"the optimizer holds {i} parameters, "
                                    f"the checkpoint's moments {len(mu)}")
    return {"state": state, "param_groups": groups}
