"""Pair-Net (R-50 or Swin-B backbone) as a served model family (see
``portbench/families/__init__.py``): the port's ``PSGTr(backbone,
PairNetHead)``, its stage boundaries, what the check keeps of a request,
and the check against the plain reference (``reference/pairnet.py``).

What the check reads of a kept request (its outputs, and the decoder's
attention masks and the mask features, read by hooks at the port's module
boundaries) is copied to the host after the request's last event: those
copies fall inside the window.
"""

from __future__ import annotations

import sys

from portbench.harness import Device, no_tf32, rel_err
from portbench.reference import init, pairnet, post

BOUNDARIES = (("backbone", "backbone"), ("pixel_decoder", "bbox_head.pixel_decoder"),
              ("decoder", "bbox_head.transformer_decoder"), ("pair_head", "bbox_head"))
CLS_KEYS = ("cls", "rel", "sub", "obj")
POST_KEYS = ("cls", "mask", "rel", "sub", "obj", "sub_seg", "obj_seg")
KEPT = ("cls", "mask", "rel", "importance", "sub", "obj", "sub_seg", "obj_seg", "sub_pos",
        "obj_pos", "queries")


def weights(model_cfg: dict, seed: int, device, dtype) -> dict:
    """Every tensor of the reference's specs, from ``seed``."""
    return init.make_weights(pairnet.param_specs(model_cfg), seed, device, dtype)


def build(model_cfg: dict, weights: dict, device, dtype, msda: str):
    """The port's ``PSGTr(backbone, PairNetHead)`` in ``dtype`` on
    ``device``, holding ``weights``, in eval mode, every MSDA on ``msda``.
    The model is allocated on ``meta`` and filled by ``load_state_dict``,
    strict: every name of the reference's specs, and only those."""
    import torch

    from pairnet_torch.flagship import set_deform_impl
    from pairnet_torch.models.frameworks.psgtr import PSGTr, build_backbone
    from pairnet_torch.models.heads.pairnet_head import PairNetHead

    with torch.device("meta"):
        bb = build_backbone(model_cfg["backbone"])
        model = PSGTr(bb, PairNetHead(bb.out_channels, **model_cfg["head"]))
    model = model.to_empty(device=device).to(dtype)
    model.load_state_dict(weights, strict=True)
    return set_deform_impl(model, msda).eval()


class Taps:
    """Hooks at the port's module boundaries that keep one request's
    decoder attention masks (the input of each decoder layer) and mask
    features (the pixel decoder's first output)."""

    def __init__(self, model):
        self.masks, self.mask_features, self.handles = [], None, []
        for name, module in model.named_modules():
            if name.startswith("bbox_head.transformer_decoder.layers.") and name.count(".") == 3:
                self.handles.append(module.register_forward_pre_hook(
                    lambda mod, args: self.masks.append(args[4][:, 0].clone())))
        self.handles.append(model.bbox_head.pixel_decoder.register_forward_hook(self._pixel))

    def _pixel(self, mod, args, out):
        self.mask_features = out[0].clone()

    def close(self):
        for h in self.handles:
            h.remove()

    def keep(self, out) -> dict:
        """The head outputs, the attention masks and the mask features, on the host."""
        return {"out": {k: out[k].cpu() for k in KEPT}, "masks": [m.cpu() for m in self.masks],
                "mask_features": self.mask_features.cpu()}


MASK_MARGIN = 0.3  # of the layer's logit standard deviation


def mask_flips(record, margin):
    """Share of attention-mask entries where the system decided otherwise
    than the reference's own logit says clearly: beyond ``margin`` of the
    layer's logit standard deviation from 0. A row is masked everywhere, and
    so attends everywhere, where its largest logit is clearly below 0; a
    row whose largest logit is near 0 is not judged."""
    bad = total = 0
    for used, lg in record:
        thr = margin * lg.std()
        top = lg.amax(-1, keepdim=True)
        cleared = top < -thr
        expect = (lg < 0) & ~cleared
        judged = ((lg.abs() > thr) | cleared) & (top.abs() > thr)
        bad += int(((used != expect) & judged).sum())
        total += lg.numel()
    return bad / max(total, 1)


def bf16(t):
    return t.bfloat16().float()


def compare(P, model_cfg, images, kept, num_things):
    """The numbers of one kept request (see :class:`Taps`). The reference
    replays the system's attention masks and pair picks, and holds each
    decision, and the heads on the system's own features, by themselves:

    * ``cls_err``: the largest relative L2 gap of the class and predicate
      logits (cls, rel, sub, obj);
    * ``mask_flips``: see :func:`mask_flips`, at ``MASK_MARGIN``;
    * ``mask_head_err``: the mask logits (mask, sub_seg, obj_seg) against
      the reference's mask head on the system's own final queries and mask
      features;
    * ``importance_x_bf16``: the PPN's importance of the system's own final
      queries against the system's, over what bf16 rounding of the same
      products gives (its queries are near orthogonal in some seeds, where
      any rounding moves the importance far);
    * ``topk_mismatch``: picks whose importance differs from the system's
      own sorted top-k importance values (exact);
    * ``post_mismatch``: the prediction entries that differ from the
      reference post-processing of the system's head outputs (exact; no
      ``got``: not compared).
    """
    out, got, masks = kept["out"], kept.get("got"), kept["masks"]
    B = images.shape[0]
    h = model_cfg["head"]
    K, layers = h["num_rel_query"], h["num_decoder_layers"]
    worst = dict.fromkeys(("cls_err", "mask_flips", "mask_head_err", "importance_x_bf16",
                           "topk_mismatch", "post_mismatch"), 0.0)
    if len(masks) != layers:  # the decoder was not driven as its layers' inputs say
        return {k: float("inf") for k in worst}

    def most(key, value):
        worst[key] = max(worst[key], float(value))

    for b in range(B):
        pairs = (out["sub_pos"][b:b + 1], out["obj_pos"][b:b + 1])
        record = []
        ref = pairnet.forward(P, images[b:b + 1].float(), model_cfg, pairs=pairs,
                              masks=[m[b:b + 1] for m in masks], record=record)
        errs = {k: rel_err(out[k][b], ref[k][0]) for k in CLS_KEYS}
        print(f"portbench: image {b}: " + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()),
              file=sys.stderr)
        most("cls_err", max(errs.values()))
        most("mask_flips", mask_flips(record, MASK_MARGIN))
        queries = out["queries"][b:b + 1].float()
        del ref, record
        mask = pairnet.mask_head(P, queries, kept["mask_features"][b:b + 1].float())[0]
        rows = {"mask": mask, "sub_seg": mask[out["sub_pos"][b]],
                "obj_seg": mask[out["obj_pos"][b]]}
        most("mask_head_err", max(rel_err(out[k][b], v) for k, v in rows.items()))
        del mask, rows
        imp = pairnet.pair_importance(P, queries)[0]
        err = rel_err(out["importance"][b], imp)
        err_bf16 = rel_err(pairnet.pair_importance(P, queries, bf16)[0], imp)
        most("importance_x_bf16", err / max(err_bf16, 1e-12))
        Q = out["importance"].shape[-1]
        have = out["importance"][b].flatten()
        picked = have[out["sub_pos"][b] * Q + out["obj_pos"][b]]
        most("topk_mismatch", (picked != have.topk(K).values).sum())
        if got is not None:
            expect = post.triplets({k: out[k][b].float() for k in POST_KEYS}, num_things)
            bad = abs(len(got[b]) - len(expect))
            for have_t, want in zip(got[b], expect):
                want = want.cpu()
                if have_t.shape != want.shape or have_t.dtype != want.dtype:
                    bad += max(have_t.numel(), want.numel())
                else:
                    bad += int((have_t.cpu() != want).sum())
            most("post_mismatch", bad)
    return worst


def reference_check(cell, seed, dev: Device, kept: dict, pool) -> dict:
    """(value, limit) of each number over the kept requests: request ``i``
    of ``kept`` served ``pool[i % len(pool)]``; without ``got`` its
    predictions are not compared."""
    import torch

    cfg = cell.config
    model_cfg = cfg["model"]
    dtype = getattr(torch, cfg["serve"]["dtype"])
    with no_tf32(), torch.no_grad():
        P = {k: v.float() for k, v in weights(model_cfg, seed, dev.device, dtype).items()}
        worst = {}
        for i, k in sorted(kept.items()):
            on_dev = {"out": {n: t.to(dev.device) for n, t in k["out"].items()},
                      "got": k["got"], "masks": [m.to(dev.device) for m in k["masks"]],
                      "mask_features": k["mask_features"].to(dev.device)}
            images = pool[i % len(pool)].to(dev.device)
            for name, v in compare(P, model_cfg, images, on_dev, cfg["num_things"]).items():
                worst[name] = max(worst.get(name, 0.0), v)
            del on_dev
    limits = cfg["limits"]["serve"]
    return {k: (worst[k], float(limits[k])) for k in limits}


def shape_counts(model_cfg: dict, image_hw, batch: int) -> dict:
    """The model FLOPs of an image and the pixel decoder's MSDA calls (its
    least time from shapes, a call; the calls a request)."""
    from portbench.counts import flops, msda

    h = model_cfg["head"]
    args = (batch, msda.encoder_shapes(image_hw), h["num_heads"],
            h["embed_dims"] // h["num_heads"], h["num_feat_levels"], 4)
    return {"flops_per_image": flops.forward_flops_per_image(model_cfg, image_hw),
            "msda_calls_per_unit": h["pixel_decoder_layers"],
            "msda_least_s": msda.least_seconds(msda.forward_bytes(*args),
                                               msda.forward_ops(*args))}


def stand_in(cell, seed, dev: Device, images, rnd) -> dict:
    """The kept requests of the plain reference in the system's place, one
    a image of ``images`` (each of batch 1), its products rounded by
    ``rnd``; its post-processing is the reference's own, so no ``got``."""
    import torch

    model_cfg = cell.config["model"]
    dtype = getattr(torch, cell.config["serve"]["dtype"])
    kept = {}
    with no_tf32(), torch.no_grad():
        P = {k: v.float() for k, v in weights(model_cfg, seed, dev.device, dtype).items()}
        for b, img in enumerate(images):
            record = []
            out = pairnet.forward(P, img.float(), model_cfg, rnd=rnd, record=record)
            kept[b] = {"out": out, "got": None, "masks": [m for m, _ in record],
                       "mask_features": out["mask_features"]}
    return kept
