"""Head type -> loss and post-processing dispatch for the CLIs and the
trainer (the port's counterpart of ``pairnet_tpu/train/dispatch.py``).

Every loss has the signature ``loss(outputs, batch, points, cum_samples,
targets=None) -> (losses, new_cum_samples)``: ``points`` (B, P, 2) are the
mask-cost samples the step draws (JAX draws them from its key inside the
loss), ``cum_samples`` the Seesaw counts, which only Pair-Net and the
Seesaw baseline and the box Pair-Net advance. Its ``num_points`` attribute is P (0 for the
heads that sample none), ``cum_size`` the length of the ``cum_samples``
it carries, given the number of predicates.
"""

from __future__ import annotations

import functools
from typing import Callable

_TWO_STAGE = ("MotifHead", "IMPHead", "GPSHead", "VCTreeHead")


def _not_ported(head_type: str):
    item = ("A.2-A.3: the two-stage models" if head_type in _TWO_STAGE
            else "A: the model zoo")
    return NotImplementedError(f"head type {head_type!r} is not ported yet (ROADMAP {item})")


def _plain_loss(loss, loss_cfg, num_points, takes_points=True):
    """A loss without Seesaw counts in the dispatch signature."""
    kw = dict(loss_cfg)

    def fn(outputs, batch, points, cum_samples, targets=None):
        args = (outputs, batch, points) if takes_points else (outputs, batch)
        return loss(*args, **kw), cum_samples

    fn.num_points = num_points
    fn.cum_size = lambda num_relations: num_relations
    return fn


def get_loss_fn(head_type: str, cfg, reduce=None) -> Callable:
    """The head's loss with the config's ``loss`` options (see the module
    doc). ``reduce`` sums a tensor over the data-parallel ranks (None:
    world size 1); every loss then normalizes by the global batch's counts."""
    loss_cfg = dict(cfg.get("loss", {}))
    if reduce is not None:
        loss_cfg["reduce"] = reduce
    if head_type == "PairNetHead":
        from pairnet_torch.models.heads.pairnet_loss import pairnet_loss

        num_points = loss_cfg.pop("num_points", 12544)
        fn = functools.partial(pairnet_loss, **loss_cfg)
        fn.num_points = num_points
        fn.cum_size = lambda num_relations: num_relations
        return fn
    if head_type in ("BaselineHead", "MyPSGFormerHead"):
        from pairnet_torch.models.heads.baseline_head import baseline_loss

        num_points = loss_cfg.pop("num_points", 12544)
        seesaw = bool(loss_cfg.get("use_seesaw"))

        def fn(outputs, batch, points, cum_samples, targets=None):
            return baseline_loss(outputs, batch, points, cum_samples, **loss_cfg)

        fn.num_points = num_points
        # CrossHead4's Seesaw runs over R + 1 classes, the background column included
        fn.cum_size = lambda num_relations: num_relations + int(seesaw)
        return fn
    if head_type == "CrossHeadBBox":
        from pairnet_torch.models.heads import pairnet_bbox_head

        if loss_cfg.pop("detection_only", False):
            # detection-only pretraining (the od_* configs): no Seesaw counts
            return _plain_loss(pairnet_bbox_head.deformable_detr_detection_loss, loss_cfg, 0,
                               takes_points=False)

        def fn(outputs, batch, points, cum_samples, targets=None):
            return pairnet_bbox_head.pairnet_bbox_loss(outputs, batch, cum_samples, **loss_cfg)

        fn.num_points = 0
        fn.cum_size = lambda num_relations: num_relations
        return fn
    if head_type == "PSGTrHead":
        from pairnet_torch.models.heads.psgtr_head import psgtr_loss

        return _plain_loss(psgtr_loss, loss_cfg, 0, takes_points=False)
    if head_type == "PSGFormerHead":
        from pairnet_torch.models.heads.psgformer_head import psgformer_loss

        return _plain_loss(psgformer_loss, loss_cfg, 0, takes_points=False)
    if head_type == "PSGTr2Head":
        from pairnet_torch.models.heads.psgtr2_head import psgtr2_loss

        num_points = loss_cfg.pop("num_points", 12544)
        return _plain_loss(psgtr2_loss, loss_cfg, num_points)
    if head_type == "Detr4SegHead":
        from pairnet_torch.models.heads.detr4seg_head import detr4seg_loss

        num_points = loss_cfg.pop("num_points", 2048)
        return _plain_loss(detr4seg_loss, loss_cfg, num_points)
    raise _not_ported(head_type)


def get_postprocess_fn(head_type: str) -> Callable:
    """Per-image raw outputs -> TripletPrediction (BoxTripletPrediction for
    the box head)."""
    if head_type == "PairNetHead":
        from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess

        return pairnet_postprocess
    if head_type in ("BaselineHead", "MyPSGFormerHead", "PSGFormerHead"):
        from pairnet_torch.models.heads.baseline_head import baseline_postprocess

        return baseline_postprocess
    if head_type == "PSGTrHead":
        from pairnet_torch.models.heads.psgtr_head import psgtr_postprocess

        return psgtr_postprocess
    if head_type == "PSGTr2Head":
        from pairnet_torch.models.heads.psgtr2_head import psgtr2_postprocess

        return psgtr2_postprocess
    if head_type == "Detr4SegHead":
        from pairnet_torch.models.heads.detr4seg_head import detr4seg_postprocess

        return detr4seg_postprocess
    if head_type == "CrossHeadBBox":
        from pairnet_torch.models.heads.pairnet_bbox_head import pairnet_bbox_postprocess

        return pairnet_bbox_postprocess
    raise _not_ported(head_type)
