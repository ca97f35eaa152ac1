"""Detector outputs (counterpart of livecell_tpu/models/detector.py:
Detections). The training losses come with the training slice."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    boxes: torch.Tensor       # [B, D, 4]
    scores: torch.Tensor      # [B, D]
    labels: torch.Tensor      # [B, D] (1 = cell)
    valid: torch.Tensor       # [B, D] bool
    mask_probs: torch.Tensor  # [B, D, 28, 28] class-1 probabilities
