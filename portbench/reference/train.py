"""Plain reference of Pair-Net's training step (float32, TF32 off).

One step: the forward of :mod:`portbench.reference.pairnet` in train
mode; the targets, held by :func:`check_targets` against scipy's
``linear_sum_assignment`` on the costs of mmdet's MaskHungarianAssigner
(point-sampled class, mask-BCE and dice costs) and of Pair-Net's triplet
assignment (subject and object class costs);
the losses of the published config (Seesaw CE on the matched relation
queries x 2, class CE on the matched subject and object slots x 4, which
train nothing, and the importance BCE with a positive weight x 5); the
gradients by autograd; a clip of the global norm at 0.1; AdamW (lr 1e-4,
weight decay 1e-4 but none on norms, betas 0.9 / 0.999, eps 1e-8) with the
published lr multipliers (0 for the stem and the first ResNet stage, 0.1
for the backbone, the pixel decoder and the Mask2Former decoder with its
query tables and heads).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from portbench.reference import pairnet

LR, WEIGHT_DECAY, BETAS, EPS, CLIP = 1e-4, 1e-4, (0.9, 0.999), 1e-8, 0.1
LR_MULT = (  # the first prefix that a parameter's name starts with decides
    ("backbone.conv1.", 0.0), ("backbone.layer1.", 0.0), ("backbone.", 0.1),
    ("bbox_head.pixel_decoder.", 0.1), ("bbox_head.transformer_decoder.", 0.1),
    ("bbox_head.query_feat.", 0.1), ("bbox_head.query_embed.", 0.1),
    ("bbox_head.level_embed.", 0.1), ("bbox_head.cls_embed.", 0.1),
    ("bbox_head.mask_embed.", 0.1),
)


def lr_mult(name: str) -> float:
    return next((m for prefix, m in LR_MULT if name.startswith(prefix)), 1.0)


def trainable(specs):
    """Names of the parameters (not the frozen BatchNorms' buffers) and of
    those without weight decay (the norms')."""
    return [n for n, _, _ in specs if n not in specs.buffers], set(specs.norms)


def point_sample(maps, points):
    """maps (B, N, H, W) at points (B, P, 2) in [0, 1] (x, y) -> (B, N, P);
    bilinear, zero outside, pixel p * size - 0.5."""
    grid = (2 * points - 1)[:, None]  # (B, 1, P, 2)
    return F.grid_sample(maps, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[:, :, 0]


def class_cost(logits, labels):
    """-softmax(logits)[gt label]: (N, C) x (G,) -> (N, G)."""
    return -torch.softmax(logits, -1)[:, labels]


def assign(cost, valid=None):
    """Minimum-cost matching of rows to the valid columns: (row -> column
    or -1, column -> row or -1)."""
    cost = cost.detach().double().cpu().numpy()
    n, m = cost.shape
    cols = np.arange(m) if valid is None else np.flatnonzero(valid.cpu().numpy())
    r, c = linear_sum_assignment(cost[:, cols])
    row2col, col2row = np.full(n, -1), np.full(m, -1)
    row2col[r], col2row[cols[c]] = cols[c], r
    return row2col, col2row


def mask_cost(cls, pred_pts, labels, gt_pts):
    """The query-to-segment cost of one image: (Q, G)."""
    P = pred_pts.shape[-1]
    bce = (-F.logsigmoid(pred_pts) @ gt_pts.T + -F.logsigmoid(-pred_pts) @ (1 - gt_pts).T) / P
    p = torch.sigmoid(pred_pts)
    dice = 1 - (2 * p @ gt_pts.T + 1) / (p.sum(-1)[:, None] + gt_pts.sum(-1)[None, :] + 1)
    return 2 * class_cost(cls, labels) + 5 * bce + 5 * dice


def targets(out, batch, points, solve=None):
    """The reference's own targets of head outputs ``out`` (float32,
    detached), by scipy's assignment (or ``solve``, a planted fault): what
    a step in the system's place (the control) trains on."""
    solve = solve or assign
    cls = out["cls"]
    B, Q = cls.shape[:2]
    K = out["rel"].shape[1]
    labels, rels = batch["gt_labels"].long(), batch["gt_rels"].long()
    G = labels.shape[1]
    pred_pts = point_sample(out["mask"], points)
    gt_pts = point_sample(batch["gt_masks"].float(), points)
    dev = cls.device
    res = {k: [] for k in ("r_labels", "r_weights", "sub_ids", "obj_ids", "gt_importance",
                           "query2gt")}
    for b in range(B):
        q2g, gt2q = solve(mask_cost(cls[b], pred_pts[b], labels[b], gt_pts[b]),
                          batch["gt_valid"][b])
        gt2q = torch.as_tensor(gt2q, device=dev)
        sub_gt, obj_gt = rels[b, :, 0].clamp(0, G - 1), rels[b, :, 1].clamp(0, G - 1)
        sub_q, obj_q = gt2q[sub_gt], gt2q[obj_gt]
        ok = batch["rel_valid"][b].bool() & (sub_q >= 0) & (obj_q >= 0)
        imp = torch.zeros(Q, Q, device=dev)
        imp[sub_q[ok], obj_q[ok]] = 1.0
        sub_cls, obj_cls, rel_lab = labels[b, sub_gt], labels[b, obj_gt], rels[b, :, 2] - 1
        r2g, _ = solve(class_cost(out["sub"][b], sub_cls) + class_cost(out["obj"][b], obj_cls),
                       ok)
        r2g = torch.as_tensor(r2g, device=dev)
        pos, safe = r2g >= 0, r2g.clamp_min(0)
        none = torch.full((K,), -1, device=dev, dtype=torch.long)
        res["r_labels"].append(torch.where(pos, rel_lab[safe], none))
        res["r_weights"].append(pos.float())
        res["sub_ids"].append(torch.where(pos, sub_cls[safe], none))
        res["obj_ids"].append(torch.where(pos, obj_cls[safe], none))
        res["gt_importance"].append(imp)
        res["query2gt"].append(torch.as_tensor(q2g, device=dev))
    return {k: torch.stack(v) for k, v in res.items()}


def optimum(cost, valid):
    """scipy's least total cost of matching the rows to the valid columns."""
    row2col, _ = assign(cost, valid)
    rows = np.flatnonzero(row2col >= 0)
    if rows.size == 0:
        return 0.0
    idx = torch.as_tensor(rows, device=cost.device)
    return float(cost[idx, torch.as_tensor(row2col[rows], device=cost.device)].double().sum())


def check_targets(out, batch, points, t):
    """Hold the system's targets ``t`` against its own head outputs
    ``out``. Returns (the worst relative excess of the cost of its
    assignments over scipy's optimum on the costs worked out here; the
    entries that no largest matching gives: segments matched twice or not
    valid, fewer matches than queries or valid segments allow, importance
    targets other than its segment matching gives, matched (subject, object,
    predicate) triples that are not valid ground-truth relations, fewer than
    the relation queries or valid relations allow)."""
    labels, rels = batch["gt_labels"].long(), batch["gt_rels"].long()
    B, G = labels.shape
    pred_pts = point_sample(out["mask"], points)
    gt_pts = point_sample(batch["gt_masks"].float(), points)
    gap, bad = 0.0, 0
    for b in range(B):
        valid = batch["gt_valid"][b].bool()
        cost = mask_cost(out["cls"][b], pred_pts[b], labels[b], gt_pts[b])
        q2g = t["query2gt"][b].long()
        matched = torch.nonzero(q2g >= 0)[:, 0]
        gt2q = torch.full((G,), -1, dtype=torch.long, device=q2g.device)
        gt2q[q2g[matched]] = matched
        bad += (int(((gt2q >= 0) & ~valid).sum()) + matched.numel() - int((gt2q >= 0).sum())
                + abs(matched.numel() - min(q2g.numel(), int(valid.sum()))))
        have = float(cost[matched, q2g[matched]].double().sum())
        best = optimum(cost, valid)
        gap = max(gap, (have - best) / max(abs(best), 1.0))

        sub_gt, obj_gt = rels[b, :, 0].clamp(0, G - 1), rels[b, :, 1].clamp(0, G - 1)
        sub_q, obj_q = gt2q[sub_gt], gt2q[obj_gt]
        ok = batch["rel_valid"][b].bool() & (sub_q >= 0) & (obj_q >= 0)
        imp = torch.zeros_like(t["gt_importance"][b])
        imp[sub_q[ok], obj_q[ok]] = 1.0
        bad += int((imp != t["gt_importance"][b]).sum())
        k = torch.nonzero(t["r_weights"][b] > 0)[:, 0]
        sub_ids, obj_ids = t["sub_ids"][b][k].long(), t["obj_ids"][b][k].long()
        got = Counter(zip(sub_ids.tolist(), obj_ids.tolist(), t["r_labels"][b][k].tolist()))
        want = Counter(zip(labels[b, sub_gt][ok].tolist(), labels[b, obj_gt][ok].tolist(),
                           (rels[b, :, 2][ok] - 1).tolist()))
        n_got, n_want = sum(got.values()), sum(want.values())
        bad += (sum((got - want).values())
                + abs(n_got - min(t["r_weights"][b].numel(), n_want)))
        p_sub, p_obj = torch.softmax(out["sub"][b], -1), torch.softmax(out["obj"][b], -1)
        have = float((-p_sub[k, sub_ids] - p_obj[k, obj_ids]).double().sum())
        cost = class_cost(out["sub"][b], labels[b, sub_gt]) + class_cost(out["obj"][b],
                                                                         labels[b, obj_gt])
        best = optimum(cost, ok)
        gap = max(gap, (have - best) / max(abs(best), 1.0))
    return gap, bad


def weighted_ce(logits, labels, w):
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    return (nll * w).sum() / w.sum().clamp_min(1e-7)


def seesaw_ce(logits, labels, w, cum, p=0.8, q=2.0, eps=1e-2):
    """mmdet's Seesaw loss; the class counts are updated first. Returns
    (loss, new counts)."""
    C = logits.shape[-1]
    lab = labels.clamp_min(0)
    onehot = F.one_hot(lab, C).float()
    cum = cum + (onehot * w[:, None]).sum(0)
    cs = cum.clamp_min(1.0)
    ratio = cs[None, :] / cs[:, None]
    factor = torch.where(ratio < 1, ratio ** p, torch.ones_like(ratio))[lab]
    scores = torch.softmax(logits.detach(), -1)
    self_score = scores.gather(-1, lab[:, None]).clamp_min(eps)
    comp = scores / self_score
    factor = factor * torch.where(comp > 1, comp ** q, torch.ones_like(comp))
    adjusted = logits + torch.log(factor) * (1 - onehot)
    return weighted_ce(adjusted, labels, w), cum


def losses(out, t, cum):
    """The published loss weights on outputs ``out`` and targets ``t``."""
    B, K, R = out["rel"].shape
    C1 = out["cls"].shape[-1]
    w = t["r_weights"].reshape(-1)
    rel, cum = seesaw_ce(out["rel"].reshape(-1, R), t["r_labels"].reshape(-1), w, cum)
    sub = weighted_ce(out["sub"].detach().reshape(-1, C1), t["sub_ids"].reshape(-1), w)
    obj = weighted_ce(out["obj"].detach().reshape(-1, C1), t["obj_ids"].reshape(-1), w)
    gt = t["gt_importance"]
    pos_weight = gt.numel() / (gt > 0).sum().float().clamp_min(1.0)
    x = out["importance"]
    match = -(pos_weight * gt * F.logsigmoid(x) + (1 - gt) * F.logsigmoid(-x)).mean()
    parts = {"loss_r_cls": 2 * rel, "loss_sub_cls": 4 * sub, "loss_obj_cls": 4 * obj,
             "loss_match": 5 * match}
    return sum(parts.values()), parts, cum


class AdamW:
    """AdamW with decoupled weight decay, per-parameter lr multipliers."""

    def __init__(self, names, no_decay):
        self.names, self.no_decay = names, no_decay
        self.m, self.v, self.t = {}, {}, 0

    def step(self, P, grads):
        self.t += 1
        b1, b2 = BETAS
        for n in self.names:
            g = grads[n]
            m = self.m[n] = b1 * self.m.get(n, torch.zeros_like(g)) + (1 - b1) * g
            v = self.v[n] = b2 * self.v.get(n, torch.zeros_like(g)) + (1 - b2) * g * g
            lr = LR * lr_mult(n)
            wd = 0.0 if n in self.no_decay else WEIGHT_DECAY
            m_hat, v_hat = m / (1 - b1 ** self.t), v / (1 - b2 ** self.t)
            P[n] = P[n] * (1 - lr * wd) - lr * m_hat / (v_hat.sqrt() + EPS)


def dropout_replay(masks, p):
    """The step's dropout: the system's keep masks, in call order."""
    it = iter(masks)
    return lambda x: x * next(it) / (1 - p)


def step(P, opt: AdamW, batch, decisions, model_cfg, cum, rnd=pairnet.identity, points=None,
         generator=None, loss_rows=None, solve=None):
    """One step of the reference from parameters ``P`` (name -> float32
    tensor, updated in place in the dict). With ``decisions`` (the
    system's attention masks, pair picks, dropout keep masks and targets of
    this step) it replays them (:func:`check_targets` holds the targets by
    themselves). Without, it takes its own, as a step in the system's place
    does (the control): its dropout from ``generator``, its targets from its
    outputs and ``points``, and it returns them. ``rnd`` rounds the
    operands of the forward's products; ``loss_rows`` keeps that many images
    in the loss and ``solve`` replaces the assignment (planted faults).
    Returns (loss, the clipped gradients, new
    Seesaw counts, the decisions)."""
    leaves = {n: P[n].detach().requires_grad_(True) for n in opt.names}
    params = {**P, **leaves}
    drop = model_cfg["head"]["relation_ffn_drop"]
    record, kept = [], []
    if decisions is None:
        def dropout(x):
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= drop
            kept.append(keep)
            return x * keep / (1 - drop)

        out = pairnet.forward(params, batch["image"].float(), model_cfg, rnd=rnd,
                              record=record, dropout=dropout)
        detached = {k: v.detach() for k, v in out.items()}
        with torch.no_grad():
            t = targets(detached, batch, points, solve)
        decisions = {"masks": [m for m, _ in record], "dropout": kept, "targets": t,
                     "pairs": (out["sub_pos"], out["obj_pos"]), "outputs": detached}
    else:
        out = pairnet.forward(params, batch["image"].float(), model_cfg, rnd=rnd,
                              pairs=decisions["pairs"], masks=decisions["masks"],
                              dropout=dropout_replay(decisions["dropout"], drop))
    t = decisions["targets"]
    if loss_rows is not None:
        out = {k: v[:loss_rows] for k, v in out.items()}
        t = {k: v[:loss_rows] for k, v in t.items()}
    total, _, cum = losses(out, t, cum)
    grads = dict(zip(opt.names, torch.autograd.grad(total, [leaves[n] for n in opt.names],
                                                    allow_unused=True)))
    grads = {n: torch.zeros_like(P[n]) if g is None else g for n, g in grads.items()}
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    scale = torch.clamp_max(CLIP / norm, 1.0)
    grads = {n: g * scale for n, g in grads.items()}
    with torch.no_grad():
        opt.step(P, grads)
    return float(total.detach()), grads, cum, decisions
