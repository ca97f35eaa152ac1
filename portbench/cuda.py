"""Waiting for the card and giving its memory back, on the card only
(the tests drive the drivers on the CPU)."""

from __future__ import annotations

import gc

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def empty() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
