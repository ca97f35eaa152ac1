"""Packed fixed-shape dataset for tiled LIVECell (counterpart of
livecell_tpu/data/dataset.py: pad_image_batch, PackedDataset,
get_datasets).

All tiles of a split are decoded once into one contiguous uint8 array
(read with the port's PNG decoder, not PIL); instance annotations are
packed into `max_instances` fixed slots with validity masks; the 28x28
mask targets are computed once per instance on `device` (the card
unless the caller passes "cpu") by ops/mask_ops.py:extract_mask_targets,
and cached on disk next to the split, under `.livecell_tpu_torch_cache/`.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
from livecell_tpu_torch.data.png import read_png
from livecell_tpu_torch.device import resolve_device

CACHE_VERSION = 2
CACHE_DIR = ".livecell_tpu_torch_cache"
MASK28_CHUNK = 256


def pad_image_batch(images_u8: np.ndarray, out_hw: Tuple[int, int]
                    ) -> np.ndarray:
    """uint8 [B, h, w, 3] -> float32 [B, H, W, 3] in [0,1], zero-padded
    bottom/right (ToTensor + static-shape padding)."""
    b, h, w, c = images_u8.shape
    oh, ow = out_hw
    out = np.zeros((b, oh, ow, c), np.float32)
    out[:, :h, :w] = images_u8.astype(np.float32) / 255.0
    return out


class PackedDataset:
    """One split of a tiled LIVECell tree, packed for feeding the card.

    `device` is where the mask targets are computed (the card unless the
    caller passes "cpu"); the packed arrays themselves are numpy."""

    def __init__(self, root_dir: str, split: str = "train",
                 model_cfg: Optional[ModelConfig] = None,
                 cache: bool = True, device=None):
        self.root_dir = Path(root_dir)
        self.split = split
        self.cfg = model_cfg or ModelConfig()
        self.device = resolve_device(device)
        self._truncation_warned = False

        self.img_dir = self.root_dir / split / "images"
        self.ann_file = self.root_dir / "annotations" / \
            f"livecell_coco_{split}.json"
        if not self.img_dir.exists():
            raise ValueError(f"Image directory not found: {self.img_dir}")
        if not self.ann_file.exists():
            raise ValueError(f"Annotation file not found: {self.ann_file}")

        cache_path = self._cache_path() if cache else None
        if cache_path is not None and cache_path.exists():
            with np.load(cache_path) as data:
                self.images = data["images"]
                self.boxes = data["boxes"]
                self.labels = data["labels"]
                self.mask28 = data["mask28"]
                self.offsets = data["offsets"]
                self.image_ids = data["image_ids"]
                self.file_names = list(data["file_names"])
        else:
            self._build()
            if cache_path is not None:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = cache_path.with_suffix(f".{os.getpid()}.tmp.npz")
                np.savez_compressed(
                    tmp, images=self.images, boxes=self.boxes,
                    labels=self.labels, mask28=self.mask28,
                    offsets=self.offsets, image_ids=self.image_ids,
                    file_names=np.asarray(self.file_names))
                os.replace(tmp, cache_path)

    # ------------------------------------------------------------------
    def _cache_path(self) -> Path:
        """The cache file of this split. The key names the device type:
        mask targets computed on the card may differ from the CPU's by
        one count."""
        stat = os.stat(self.ann_file)
        key = f"{CACHE_VERSION}:{stat.st_size}:{stat.st_mtime_ns}:" \
              f"{self.cfg.mask_size}:{self.device.type}"
        h = hashlib.sha1(key.encode()).hexdigest()[:12]
        return self.root_dir / CACHE_DIR / f"{self.split}_{h}.npz"

    def _build(self):
        coco = CocoIndex(self.ann_file)
        img_ids = sorted(coco.imgs.keys())

        images, all_boxes, all_labels, anns = [], [], [], []
        offsets = [0]
        file_names = []
        th = tw = None
        for img_id in img_ids:
            info = coco.imgs[img_id]
            th = th or info["height"]
            tw = tw or info["width"]
            arr = read_png(self.img_dir / info["file_name"])
            if arr.shape[:2] != (th, tw):  # guard: uniform tile grid
                padded = np.zeros((th, tw, 3), np.uint8)
                padded[:arr.shape[0], :arr.shape[1]] = arr[:th, :tw]
                arr = padded
            images.append(arr)
            file_names.append(info["file_name"])

            count = 0
            for ann in coco.get_anns(img_id):
                if ann.get("iscrowd", 0):
                    continue  # the reference skips crowds
                x, y, w, h = ann["bbox"]
                all_boxes.append([x, y, x + w, y + h])
                all_labels.append(ann["category_id"])
                anns.append(ann)
                count += 1
            offsets.append(offsets[-1] + count)

        self.images = np.stack(images) if images else \
            np.zeros((0, 1, 1, 3), np.uint8)
        self.offsets = np.asarray(offsets, np.int64)
        self.image_ids = np.asarray(img_ids, np.int64)
        self.file_names = file_names
        n_inst = len(all_boxes)
        self.boxes = np.asarray(all_boxes, np.float32).reshape(n_inst, 4)
        self.labels = np.asarray(all_labels, np.int32)
        self.mask28 = self._compute_mask28(anns, self.boxes, (th, tw))

    def _compute_mask28(self, anns, boxes, hw) -> np.ndarray:
        """The mask targets of every instance on self.device, in chunks of
        MASK28_CHUNK instances (each chunk's dense masks rasterized on the
        host, sent as uint8), rounded to uint8 counts of 1/255."""
        from livecell_tpu_torch.ops.mask_ops import extract_mask_targets

        ms = self.cfg.mask_size
        if not anns:
            return np.zeros((0, ms, ms), np.uint8)
        outs = []
        for i in range(0, len(anns), MASK28_CHUNK):
            dense = np.stack([ann_to_mask(a, *hw)
                              for a in anns[i:i + MASK28_CHUNK]])
            m = torch.from_numpy(dense).to(self.device)
            b = torch.from_numpy(boxes[i:i + MASK28_CHUNK]).to(self.device)
            t = extract_mask_targets(m, b, ms)
            outs.append(torch.round(t * 255).clamp(0, 255).to(torch.uint8))
        return torch.cat(outs).cpu().numpy()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.images)

    @property
    def tile_hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def instance_counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, Dict]:
        """Assemble a fixed-shape batch for the given tile indices: images
        padded or cropped to the model input, uint8 (the step normalizes
        on the card), and max_instances slots of boxes, labels, uint8
        mask targets and validity."""
        cfg = self.cfg
        b = len(indices)
        i_max = cfg.max_instances
        h, w = self.images.shape[1:3]
        images = np.zeros((b, cfg.image_height, cfg.image_width, 3),
                          np.uint8)
        ch, cw = min(h, cfg.image_height), min(w, cfg.image_width)
        images[:, :ch, :cw] = self.images[indices][:, :ch, :cw]
        boxes = np.zeros((b, i_max, 4), np.float32)
        labels = np.zeros((b, i_max), np.int32)
        mask28 = np.zeros((b, i_max, cfg.mask_size, cfg.mask_size),
                          np.uint8)
        valid = np.zeros((b, i_max), bool)
        for bi, idx in enumerate(indices):
            lo, hi = self.offsets[idx], self.offsets[idx + 1]
            n = min(hi - lo, i_max)
            if hi - lo > i_max and not self._truncation_warned:
                self._truncation_warned = True
                warnings.warn(
                    f"tile has {hi - lo} instances but max_instances="
                    f"{i_max}; ground truth beyond the cap is dropped "
                    f"(split max is {int(self.instance_counts().max())} — "
                    f"raise DataConfig.max_instances to cover it)",
                    stacklevel=2)
            boxes[bi, :n] = self.boxes[lo:lo + n]
            labels[bi, :n] = self.labels[lo:lo + n]
            mask28[bi, :n] = self.mask28[lo:lo + n]
            valid[bi, :n] = True
        return images, {"boxes": boxes, "labels": labels,
                        "mask28": mask28, "valid": valid}

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                pad_final: bool = True
                ) -> Iterator[Tuple[np.ndarray, Dict, np.ndarray]]:
        """Yield (images, targets, batch_valid) with a constant batch
        shape; the final short batch is padded with tile 0 and flagged
        in batch_valid."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                if pad_final:
                    pad = np.zeros(batch_size - len(idx), np.int64)
                    bvalid = np.zeros(batch_size, bool)
                    bvalid[:len(idx)] = True
                    idx = np.concatenate([idx, pad])
                else:
                    bvalid = np.ones(len(idx), bool)
                    images, targets = self.gather(idx)
                    yield images, targets, bvalid
                    return
            else:
                bvalid = np.ones(batch_size, bool)
            images, targets = self.gather(idx)
            yield images, targets, bvalid


def get_datasets(root_dir: str, model_cfg: Optional[ModelConfig] = None,
                 device=None) -> Dict[str, PackedDataset]:
    """All three splits that load (the reference's get_dataloaders); a
    split that fails to load is reported and left out."""
    out = {}
    for split in ("train", "val", "test"):
        try:
            out[split] = PackedDataset(root_dir, split, model_cfg,
                                       device=device)
            print(f"Loaded {split}: {len(out[split])} tiles")
        except (ValueError, OSError) as e:
            print(f"Failed to load {split} dataset: {e}")
    return out
