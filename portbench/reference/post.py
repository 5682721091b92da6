"""Plain reference of Pair-Net's inference post-processing of one image.

From the head outputs of one image to the triplet prediction, as the
reference implementation's ``CrossHead`` simple-test does:

* subject and object labels: argmax of the class softmax without the
  background column, 1-based;
* predicate distribution: softmax with a zero background column first;
  its label is the argmax over the predicates (1-based) and its score the
  largest probability;
* panoptic fusion (DETR style): a query is kept if its score is above 0.5
  and its label is not the last foreground class (a quirk of the reference
  code, kept); each pixel takes the kept query of the largest mask logit;
  kept stuff queries of one class merge into the first of them; segments
  of at most 4 pixels are dropped and the fusion redone until none is
  left; the pixel's id is ``query * 1000 + label``, or ``1000 + 133`` where
  nothing is kept;
* subject and object masks: sigmoid of the mask logits above 0.5.

Every value is computed in float32. The fields come in the order of the
system's ``TripletPrediction``.
"""

from __future__ import annotations

import torch

FIELDS = ("labels", "rel_pairs", "masks", "pan_seg", "r_dists", "r_labels", "r_scores")
INSTANCE_OFFSET = 1000
NO_OBJECT = 133


def fusion(cls, mask, num_things, score_thr=0.5, min_area=4):
    Q, C1 = cls.shape
    probs = torch.softmax(cls, -1)[:, :-1]
    scores, labels = probs.amax(-1), probs.argmax(-1)
    keep = (labels != C1 - 2) & (scores > score_thr)
    H, W = mask.shape[-2:]
    flat = mask.reshape(Q, H * W)
    q = torch.arange(Q, device=cls.device)
    same = (labels[:, None] == labels[None, :]) & keep[None, :]
    first = torch.where(same, q[None, :], Q).min(1).values
    target = torch.where((labels >= num_things) & keep & (first < Q), first, q)
    while True:
        if keep.any():
            owner = target[torch.where(keep[:, None], flat, float("-inf")).argmax(0)]
        else:
            owner = torch.zeros(H * W, dtype=torch.long, device=cls.device)
        area = torch.bincount(owner, minlength=Q)
        small = keep & (area <= min_area)
        if not small.any():
            break
        keep = keep & ~small
    if keep.any():
        pan = owner * INSTANCE_OFFSET + labels[owner]
    else:
        pan = torch.full_like(owner, INSTANCE_OFFSET + NO_OBJECT)
    return pan.reshape(H, W)


def triplets(out: dict, num_things: int = 80) -> tuple:
    """One image's outputs (float32, no batch axis) -> the prediction's
    fields, in :data:`FIELDS` order."""
    rel = out["rel"]
    K = rel.shape[0]
    sub = torch.softmax(out["sub"], -1)[:, :-1].argmax(-1) + 1
    obj = torch.softmax(out["obj"], -1)[:, :-1].argmax(-1) + 1
    r = torch.cat([torch.zeros((K, 1), device=rel.device), torch.softmax(rel, -1)], -1)
    k = torch.arange(K, device=rel.device)
    return (
        torch.cat([sub, obj]),
        torch.stack([k, k + K], -1),
        torch.cat([torch.sigmoid(out["sub_seg"]) > 0.5, torch.sigmoid(out["obj_seg"]) > 0.5]),
        fusion(out["cls"], out["mask"], num_things),
        r,
        r[:, 1:].argmax(-1) + 1,
        r[:, 1:].max(-1).values,
    )
