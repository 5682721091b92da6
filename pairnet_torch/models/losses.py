"""Loss functions of the Pair-Net training step (fixed shapes, mask-weighted).

Counterpart of ``pairnet_tpu/models/losses.py``:

* Seesaw CE (mmdet SeesawLoss, p=0.8 q=2.0) for relation classification,
  with the running per-class sample counts carried as ``cum_samples``;
* weighted softmax CE (mmdet CrossEntropyLoss) for the class losses;
* BCE-with-logits with a pos_weight for the importance matrix;
* point-sampled mask BCE and naive dice for the optional segmentation losses;
* the reference's sigmoid focal BCE and softmax focal NLL (``bce_focal_loss``,
  ``multilabel_focal_loss``).

Reductions are weighted means, ``sum(loss * w) / max(sum(w), eps)``, so
padded slots never contribute. Every loss computes in f32.

Data parallelism: each reduction takes ``reduce``, a callable that sums a
tensor over the ranks (``parallel/mesh.py::all_reduce_sum``). With it a
rank's loss is its local numerator over the GLOBAL denominator, so the
ranks' losses, and their gradients, sum to the global batch's, as in
JAX's SPMD step. ``reduce=None`` is world size 1 and computes exactly what
it did before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _global(t, reduce):
    """``t`` summed over the ranks (a detached copy), or ``t`` itself at
    world size 1."""
    return t if reduce is None else reduce(t.detach().clone())


def _wmean(x, w, eps=1e-7, reduce=None):
    return torch.sum(x * w) / torch.clamp_min(_global(torch.sum(w), reduce), eps)


def softmax_ce(logits, labels, weights, class_weight=None, reduce=None):
    """Weighted-mean softmax cross entropy; labels are clipped for padded
    slots. With ``class_weight`` the mean is normalized by the summed
    per-sample class weights, as ``F.cross_entropy(weight=...)`` does."""
    C = logits.shape[-1]
    labels_safe = labels.clamp(0, C - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    if class_weight is not None:
        cw = class_weight[labels_safe]
        return torch.sum(nll * cw * weights) / torch.clamp_min(
            _global(torch.sum(cw * weights), reduce), 1e-7)
    return _wmean(nll, weights, reduce=reduce)


def seesaw_ce(logits, labels, weights, cum_samples, p=0.8, q=2.0, eps=1e-2, reduce=None):
    """mmdet seesaw_ce_loss: returns (loss, updated cum_samples).

    The counts are updated before the weights are computed (mmdet's
    SeesawLoss.forward updates its buffer first), by the global batch's
    counts, so ``cum_samples`` stays equal on every rank; the compensation
    factor reads detached scores."""
    C = logits.shape[-1]
    labels_safe = labels.clamp(0, C - 1).long()
    gt_onehot = F.one_hot(labels_safe, C).float()
    cum_samples = cum_samples + _global((gt_onehot * weights[..., None]).sum(dim=0), reduce)

    seesaw = torch.ones((labels_safe.shape[0], C), device=logits.device)
    if p > 0:
        cs = cum_samples.clamp_min(1.0)
        ratio = cs[None, :] / cs[:, None]  # (C, C): N_j / N_i
        mitig = torch.where(ratio < 1.0, torch.pow(ratio, p), torch.ones_like(ratio))
        seesaw = seesaw * mitig[labels_safe]
    if q > 0:
        scores = torch.softmax(logits.detach().float(), dim=-1)
        self_scores = torch.gather(scores, -1, labels_safe[:, None])
        score_ratio = scores / self_scores.clamp_min(eps)
        comp = torch.where(score_ratio > 1.0, torch.pow(score_ratio, q),
                           torch.ones_like(score_ratio))
        seesaw = seesaw * comp

    adj_logits = logits.float() + torch.log(seesaw) * (1.0 - gt_onehot)
    logp = torch.log_softmax(adj_logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[:, None])[:, 0]
    return _wmean(nll, weights, reduce=reduce), cum_samples


def bce_with_logits_pos_weight(logits, targets, pos_weight, numel=None):
    """``BCEWithLogitsLoss(pos_weight=...)``, mean over all elements; with
    ``numel`` (the global batch's element count) the sum over ``numel``."""
    x = logits.float()
    t = targets.float()
    loss = -(pos_weight * t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))
    if numel is None or numel == loss.numel():
        return loss.mean()
    return loss.sum() / numel


def sigmoid_bce(logits, targets):
    """Elementwise BCE-with-logits (no reduction)."""
    x = logits.float()
    t = targets.float()
    return -(t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))


def naive_dice_loss(pred_logits, targets, weights, eps=1.0, reduce=None):
    """mmdet DiceLoss(naive_dice=True, activate=True, eps=1.0) over the last
    axis, weighted mean over the rows."""
    p = torch.sigmoid(pred_logits.float())
    t = targets.float()
    num = 2.0 * torch.sum(p * t, dim=-1)
    den = torch.sum(p, dim=-1) + torch.sum(t, dim=-1)
    return _wmean(1.0 - (num + eps) / (den + eps), weights, reduce=reduce)


def bce_focal_loss(logits, targets, num_matches, gamma=2.0, alpha=0.25, loss_weight=1.0):
    """Sigmoid focal BCE with the reference's ``.mean(1).sum() / num_matches``
    reduction (its BCEFocalLoss). logits, targets (N, C)."""
    x = logits.float()
    t = targets.float()
    prob = torch.sigmoid(x)
    ce = -(t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))
    p_t = prob * t + (1.0 - prob) * (1.0 - t)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    return loss_weight * torch.sum(torch.mean(loss, dim=1)) / num_matches


def multilabel_focal_loss(logits, labels, weights, class_weight=None, gamma=2.0,
                          loss_weight=1.0):
    """Softmax focal NLL, ``-(1 - p)^gamma log p`` at the label, with
    per-class weights normalized as ``nll_loss(weight=...)`` (the
    reference's MultilabelFocalLoss); without them a weighted mean."""
    C = logits.shape[-1]
    labels_safe = labels.clamp(0, C - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    focal_logp = torch.pow(1.0 - torch.exp(logp), gamma) * logp
    nll = -torch.gather(focal_logp, -1, labels_safe[..., None])[..., 0]
    if class_weight is not None:
        cw = class_weight[labels_safe]
        return loss_weight * torch.sum(nll * cw * weights) / torch.clamp_min(
            torch.sum(cw * weights), 1e-7)
    return loss_weight * _wmean(nll, weights)
