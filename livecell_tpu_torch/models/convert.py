"""JAX variables -> port state dict (no JAX import: the JAX tree comes in
as nested dicts of numpy arrays).

The port's module names mirror the JAX parameter tree, so the key
mapping is mechanical (`a/b/kernel` -> `a.b.weight`):
  conv kernel HWIO -> OIHW; the mask head's transposed-conv kernel is
    flipped in space and reordered to torch's [in, out, kh, kw];
  dense kernel [in, out] -> [out, in] (box_head/fc1 included: the port
    flattens ROI features (y, x, c)-major like the JAX package);
  bn scale/bias/mean/var -> weight/bias/running_mean/running_var;
  rpn/cls_logits and rpn/bbox_pred 1x1 kernels -> the fused rpn.fused.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

_RPN_PARTS = ("rpn/cls_logits/", "rpn/bbox_pred/")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _kernel(key: str, w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        if "deconv" in key:
            return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim != 2:
        raise ValueError(f"{key}: unexpected kernel rank {w.ndim}")
    return w.T


def from_jax_variables(variables_np) -> "OrderedDict[str, torch.Tensor]":
    """{"params": ..., "batch_stats": ...} of the JAX CustomMaskRCNN, as
    nested dicts of numpy arrays -> a state dict for
    `CustomMaskRCNN.load_state_dict(..., strict=True)`. Every JAX leaf
    is used and every port key is written exactly once."""
    params = _flatten(variables_np["params"])
    stats = _flatten(variables_np.get("batch_stats", {}))
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(key: str, arr: np.ndarray) -> None:
        if key in sd:
            raise KeyError(f"port key {key} written twice")
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    for key, w in params.items():
        if key.startswith(_RPN_PARTS):
            continue
        base = key.replace("/", ".")
        if key.endswith("/kernel"):
            put(base[:-len("kernel")] + "weight", _kernel(key, w))
        elif key.endswith("/scale"):
            put(base[:-len("scale")] + "weight", w)
        elif key.endswith("/bias"):
            put(base, w)
        else:
            raise KeyError(f"unmapped param leaf: {key}")

    rpn = [params[p + leaf] for leaf in ("kernel", "bias") for p in _RPN_PARTS]
    put("rpn.fused.weight", np.concatenate(
        [rpn[0][0, 0], rpn[1][0, 0]], axis=1).T[:, :, None, None])
    put("rpn.fused.bias", np.concatenate([rpn[2], rpn[3]]))

    for key, w in stats.items():
        base = key.replace("/", ".")
        if key.endswith("/mean"):
            put(base[:-len("mean")] + "running_mean", w)
        elif key.endswith("/var"):
            put(base[:-len("var")] + "running_var", w)
            # torch's BN step counter has no JAX counterpart.
            sd[base[:-len("var")] + "num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unmapped stat leaf: {key}")
    return sd
