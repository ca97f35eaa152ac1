"""Fixed-shape greedy NMS, batched over leading dimensions (counterpart
of livecell_tpu/ops/nms.py: nms_fixed, nms_iterated).

`nms_fixed` runs exactly `max_keep` greedy steps; each picks the
highest-scoring live candidate (first index among equal scores, as
`argmax`) and kills every live candidate whose IoU with it is strictly
greater than the threshold. `nms_iterated` solves the same recurrence
by sweeps over the [N, N] suppression matrix. Both fill `max_keep`
fixed slots plus a validity mask, and neither reads a tensor on the
host, so they never wait for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from livecell_tpu_torch.ops.boxes import box_iou

_NEG = -1e9


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    max_keep: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [..., N] candidates.

    Args:
      boxes: [..., N, 4] xyxy; scores: [..., N]; valid: optional
        [..., N] bool (invalid rows are never picked).

    Returns:
      keep_idx [..., max_keep] int64 in pick order; slots past the
      survivors repeat the argmax of a fully suppressed row, so mask
      them with keep_valid [..., max_keep] bool.
    """
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    iou = box_iou(boxes, boxes).reshape(-1, n, n)          # [M, N, N]
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, _NEG))
    live = live.reshape(-1, n)
    m = live.shape[0]
    ar = torch.arange(n, device=live.device)
    rows = torch.arange(m, device=live.device)
    keep_idx = torch.zeros((m, max_keep), dtype=torch.int64,
                           device=live.device)
    keep_val = torch.zeros((m, max_keep), dtype=torch.bool,
                           device=live.device)
    neg = torch.full_like(live, _NEG)
    for step in range(max_keep):
        masked = torch.where(live > _NEG / 2, live, neg)
        pick = masked.argmax(dim=1)                          # [M]
        ok = masked[rows, pick] > _NEG / 2
        keep_idx[:, step] = pick
        keep_val[:, step] = ok
        suppress = (iou[rows, pick] > iou_thresh) | (ar == pick[:, None])
        live = torch.where(ok[:, None] & suppress, neg, live)
    return (keep_idx.reshape(lead + (max_keep,)),
            keep_val.reshape(lead + (max_keep,)))


def nms_iterated(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    max_keep: int,
    valid: Optional[torch.Tensor] = None,
    max_sweeps: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [..., N] candidates by iterated sweeps.

    Greedy NMS is the fixpoint of alive[i] = no j ranked above i with
    alive[j] and iou[j, i] > thresh. From the all-valid set, sweeps are
    taken in pairs and the even iterate is carried (a shrinking chain of
    supersets of the greedy set). The JAX package stops once a pair
    changes nothing or after ceil(max_sweeps / 2) pairs; an iterate
    stops changing once its pair changed nothing, so running all
    ceil(max_sweeps / 2) pairs gives the same set without a host read,
    also where the sweeps run out first.

    Returns (keep_idx [..., max_keep] int64, keep_valid [..., max_keep]
    bool): the survivors in descending-score order, ties by index.
    """
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    iou = box_iou(boxes, boxes).reshape(-1, n, n)           # [M, N, N]
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, _NEG))
    live = live.reshape(-1, n)
    ok = live > _NEG / 2
    order = torch.argsort(-live, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)         # [M, N]
    # sup[m, j, i]: j ranks above i and overlaps it. 0/1 values, so a
    # bf16 product with f32 accumulation counts exactly.
    sup = ((rank[:, :, None] < rank[:, None, :])
           & (iou > iou_thresh)).to(torch.bfloat16)

    def sweep(alive):
        killed = torch.bmm(alive.to(torch.bfloat16)[:, None], sup)[:, 0] > 0
        return ok & ~killed

    alive = ok
    for _ in range((max_sweeps + 1) // 2):
        alive = sweep(sweep(alive))
    sel = torch.where(alive, live, torch.full_like(live, _NEG))
    # jax.lax.top_k's order: descending, the lowest index first among
    # equal values.
    kval, kidx = torch.sort(sel, dim=-1, descending=True, stable=True)
    kval, kidx = kval[:, :max_keep], kidx[:, :max_keep]
    return (kidx.reshape(lead + (max_keep,)),
            (kval > _NEG / 2).reshape(lead + (max_keep,)))
