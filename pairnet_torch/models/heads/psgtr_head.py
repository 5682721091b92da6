"""PSGTr head: a triplet DETR for one-stage scene graphs.

Counterpart of ``pairnet_tpu/models/heads/psgtr_head.py`` with the
reference checkpoint's module names (mmdet ``DetrTransformer``:
``transformer.encoder.layers.<i>``, ``transformer.decoder.layers.<i>``,
``transformer.decoder.post_norm``; DETR's ``MHAttentionMap`` and
``MaskHeadSmallConv``). A post-norm DETR transformer (6 + 6 layers) runs
over the stride-32 map; every query predicts a whole triplet:

* subject / object / predicate classes and subject / object boxes
  (3-layer MLP -> sigmoid, normalized cxcywh), per decoder layer;
* subject / object masks: per-query attention maps over the memory (softmax
  of q.k, no values) with the projected features into a conv stack that
  upsamples stride 32 -> 4 through three FPN adapters.

The mask head applies each 1x1 adapter once per image and broadcasts its
output over the queries, and splits its first 3x3 conv into the projected
features' part (once per image) and the attention maps' part (per query):
both are linear, so this is JAX's function (which repeats the FPN features
and the projection once per query) with only the per-query tensors made
per query.

Training: ``htri_match`` (HTriMatcher) assigns queries to GT triplets on
class + L1 + gIoU costs; every decoder layer's assignment is solved in one
batched Hungarian call. ``psgtr_loss`` gives the per-layer losses.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.layers import FFN, LN_EPS, AttnSlot, sine_positional_encoding
from pairnet_torch.models.losses import _global
from pairnet_torch.models.matchers import classification_cost
from pairnet_torch.ops.boxes import cxcywh_to_xyxy, generalized_box_iou, xyxy_to_cxcywh
from pairnet_torch.ops.hungarian import batched_hungarian
from pairnet_torch.parallel.mesh import world_info


class DETREncoderLayer(nn.Module):
    """self_attn -> norm -> ffn -> norm (post-norm); the positions go into
    the queries and keys."""

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=2048):
        super().__init__()
        self.attentions = nn.ModuleList([AttnSlot(embed_dims, num_heads)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, x, pos):
        q = x + pos
        x = self.norms[0](x + self.attentions[0](q, q, x))
        return self.norms[1](x + self.ffns[0](x))


class DETRDecoderLayer(nn.Module):
    """DETR order: self_attn -> norm -> cross_attn -> norm -> ffn -> norm."""

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=2048):
        super().__init__()
        self.attentions = nn.ModuleList(
            [AttnSlot(embed_dims, num_heads), AttnSlot(embed_dims, num_heads)]
        )
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, q, qpos, memory, mpos):
        x = self.norms[0](q + self.attentions[0](q + qpos, q + qpos, q))
        x = self.norms[1](x + self.attentions[1](x + qpos, memory + mpos, memory))
        return self.norms[2](x + self.ffns[0](x))


class DETRTransformer(nn.Module):
    """One encoder and one decoder per name of ``decoders`` (PSGTr:
    ``("decoder",)``; PSGFormer's dual transformer: ``("decoder1",
    "decoder2")``), each decoder with its own ``post_norm`` shared by its
    layers."""

    def __init__(self, embed_dims=256, num_heads=8, num_encoder_layers=6, num_decoder_layers=6,
                 feedforward_channels=2048, decoders=("decoder",)):
        super().__init__()
        C = embed_dims
        self.decoder_names = tuple(decoders)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [DETREncoderLayer(C, num_heads, feedforward_channels)
             for _ in range(num_encoder_layers)]
        )
        for name in self.decoder_names:
            dec = nn.Module()
            dec.layers = nn.ModuleList(
                [DETRDecoderLayer(C, num_heads, feedforward_channels)
                 for _ in range(num_decoder_layers)]
            )
            dec.post_norm = nn.LayerNorm(C, eps=LN_EPS)
            self.add_module(name, dec)

    def forward(self, tokens, pos, *query_embeds):
        """tokens (B, S, C); pos (1, S, C); one (Q, C) query table per
        decoder. Returns (per decoder the post-normed output of every
        layer, the memory)."""
        mem = tokens
        for layer in self.encoder.layers:
            mem = layer(mem, pos)
        B, C = tokens.shape[0], tokens.shape[-1]
        outs = []
        for name, query_embed in zip(self.decoder_names, query_embeds):
            dec = getattr(self, name)
            qpos = query_embed[None].to(tokens.dtype)
            x = tokens.new_zeros((B, query_embed.shape[0], C))
            layers_out = []
            for layer in dec.layers:
                x = layer(x, qpos, mem, pos)
                layers_out.append(x)
            outs.append([dec.post_norm(o) for o in layers_out])
        return outs, mem


class DetrMLP(nn.Module):
    """mmdet's MLP: Linear layers in ``layers.<i>``, ReLU between them."""

    def __init__(self, in_dim, hidden_dim, out_dim, num_layers=3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList([nn.Linear(i, o) for i, o in zip(dims, outs)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = F.relu(x)
        return x


class MHAttentionMap(nn.Module):
    """Per-query multi-head 2D attention maps: softmax of q.k over the
    map, in f32, no values (DETR's ``MHAttentionMap``)."""

    def __init__(self, query_dim, hidden_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(query_dim, hidden_dim)
        self.k_linear = nn.Linear(query_dim, hidden_dim)

    def forward(self, q, k_map):
        """q (B, Q, C); k_map (B, C, h, w) -> (B, Q, heads, h, w) f32."""
        B, Q, _ = q.shape
        h, w = k_map.shape[-2:]
        Hh = self.num_heads
        qh = self.q_linear(q)
        D = qh.shape[-1] // Hh
        kh = F.conv2d(k_map, self.k_linear.weight[:, :, None, None], self.k_linear.bias)
        qh = qh.reshape(B, Q, Hh, D) * (float(D) ** -0.5)
        kh = kh.reshape(B, Hh, D, h, w)
        logits = torch.einsum("bqnc,bnchw->bqnhw", qh.float(), kh.float())
        return torch.softmax(logits.reshape(B, Q, Hh, h * w), dim=-1).reshape(B, Q, Hh, h, w)


def nearest_up(x, size):
    """Nearest upsample of (N, C, h, w) to ``size`` by JAX's integer rule:
    source row ``i * h // H`` (``F.interpolate`` computes it in floating
    point, which can differ where H is not a multiple of h)."""
    H, W = size
    h, w = x.shape[-2:]
    ys = torch.arange(H, device=x.device) * h // H
    xs = torch.arange(W, device=x.device) * w // W
    return x.index_select(-2, ys).index_select(-1, xs)


class MaskHeadSmallConv(nn.Module):
    """DETR's panoptic mask head: conv + GroupNorm(gcd(8, ch)) + ReLU
    stages with three FPN adapters, stride 32 -> 4."""

    def __init__(self, dim, fpn_dims, context_dim=256):
        super().__init__()
        inter = [dim, context_dim // 2, context_dim // 4, context_dim // 8, context_dim // 16]
        for j in range(1, 6):
            cin, cout = (dim, dim) if j == 1 else (inter[j - 2], inter[j - 1])
            self.add_module(f"lay{j}", nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"gn{j}", nn.GroupNorm(math.gcd(8, cout), cout, eps=LN_EPS))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)
        for j in range(1, 4):
            self.add_module(f"adapter{j}", nn.Conv2d(fpn_dims[j - 1], inter[j], 1))

    def forward(self, proj, attn, fpn_feats):
        """proj (B, C, h32, w32) per image; attn (B, Q, heads, h32, w32);
        fpn_feats [C4, C3, C2] per image, NCHW. -> (B, Q, h4, w4)."""
        B, Q = attn.shape[:2]
        C = proj.shape[1]
        w1 = self.lay1.weight
        # conv(cat(proj, attn)) = conv_proj(proj) + conv_attn(attn): the first once per image
        x = F.conv2d(proj, w1[:, :C], self.lay1.bias, padding=1)
        a = F.conv2d(attn.flatten(0, 1).to(w1.dtype), w1[:, C:], padding=1)
        x = (x[:, None] + a.unflatten(0, (B, Q))).flatten(0, 1)
        x = F.relu(self.gn1(x))
        x = F.relu(self.gn2(self.lay2(x)))
        for j, feat in enumerate(fpn_feats, start=1):
            lat = getattr(self, f"adapter{j}")(feat)  # once per image
            x = nearest_up(x, lat.shape[-2:]).unflatten(0, (B, Q)) + lat[:, None]
            x = getattr(self, f"lay{j + 2}")(x.flatten(0, 1))
            x = F.relu(getattr(self, f"gn{j + 2}")(x))
        return self.out_lay(x)[:, 0].unflatten(0, (B, Q))


def mask_branch(proj, memory, query, attention: MHAttentionMap, head: MaskHeadSmallConv, feats):
    """The DETR mask branch of the final decoder layer's queries: attention
    maps over the memory, then the mask head. proj (B, C, h32, w32) is the
    projected C5, memory (B, h32*w32, C), feats the backbone's (C2..C5)."""
    B, C, h, w = proj.shape
    mem_map = memory.transpose(1, 2).reshape(B, C, h, w)
    attn = attention(query, mem_map)
    return head(proj, attn, [feats[2], feats[1], feats[0]])


def detr_tokens(proj):
    """(tokens (B, S, C), positions (1, S, C)) of a projected C5 map."""
    B, C, h, w = proj.shape
    pos = sine_positional_encoding(h, w, C // 2, dtype=proj.dtype, device=proj.device)
    return proj.flatten(2).transpose(1, 2), pos.reshape(1, h * w, C)


class PSGTrHead(nn.Module):
    def __init__(self, in_channels, num_classes=133, num_relations=56, num_query=100,
                 embed_dims=256, num_heads=8, num_encoder_layers=6, num_decoder_layers=6,
                 use_mask=True):
        super().__init__()
        C = embed_dims
        self.num_heads = num_heads
        self.use_mask = use_mask
        self.input_proj = nn.Conv2d(in_channels[-1], C, 1)
        self.query_embed = nn.Embedding(num_query, C)
        self.transformer = DETRTransformer(C, num_heads, num_encoder_layers, num_decoder_layers)
        self.sub_cls_embed = nn.Linear(C, num_classes + 1)
        self.obj_cls_embed = nn.Linear(C, num_classes + 1)
        self.rel_cls_embed = nn.Linear(C, num_relations + 1)
        self.sub_box_embed = DetrMLP(C, C, 4, 3)
        self.obj_box_embed = DetrMLP(C, C, 4, 3)
        if use_mask:
            fpn_dims = [in_channels[2], in_channels[1], in_channels[0]]
            for side in ("sub", "obj"):
                self.add_module(f"{side}_bbox_attention", MHAttentionMap(C, C, num_heads))
                self.add_module(f"{side}_mask_head",
                                MaskHeadSmallConv(C + num_heads, fpn_dims, C))

    def forward(self, feats):
        """feats: backbone (C2, C3, C4, C5) NCHW."""
        proj = self.input_proj(feats[-1])
        tokens, pos = detr_tokens(proj)
        (outs,), memory = self.transformer(tokens, pos, self.query_embed.weight)
        layers = {
            "sub": [self.sub_cls_embed(o) for o in outs],
            "obj": [self.obj_cls_embed(o) for o in outs],
            "rel": [self.rel_cls_embed(o) for o in outs],
            "sub_box": [torch.sigmoid(self.sub_box_embed(o)) for o in outs],
            "obj_box": [torch.sigmoid(self.obj_box_embed(o)) for o in outs],
        }
        out = {k: v[-1] for k, v in layers.items()}
        out["layers"] = layers
        if self.use_mask:
            for side in ("sub", "obj"):
                out[f"{side}_seg"] = mask_branch(
                    proj, memory, outs[-1], getattr(self, f"{side}_bbox_attention"),
                    getattr(self, f"{side}_mask_head"), feats)
        return out


# --------------------------------------------------------------------- training


def world_count(n: int, reduce) -> int:
    """``n`` per rank as the global batch's count (x world size under a
    ``reduce``)."""
    return n if reduce is None else n * world_info()[1]


def image_scale(image_shape):
    """(B, 1, 4) f32 (w, h, w, h) of ``image_shape`` (B, 2) as (h, w)."""
    return image_shape.flip(-1).repeat(1, 2).float()[:, None, :]


def normalize_boxes(boxes, image_shape):
    """xyxy pixel boxes (B, N, 4) -> cxcywh over the image's (w, h, w, h),
    clipped to [0, 1]."""
    return (xyxy_to_cxcywh(boxes.float()) / image_scale(image_shape)).clamp(0, 1)


def tile(t, n):
    """``t`` (B, ...) repeated ``n`` times along the batch: the (layer,
    image) problems of one batched Hungarian call."""
    return t.repeat((n,) + (1,) * (t.dim() - 1))


def l1_cost(pred, gt):
    """mmdet BBoxL1Cost on normalized cxcywh: (B, Q, 4), (B, R, 4) -> (B, Q, R)."""
    return (pred[:, :, None, :] - gt[:, None, :, :]).abs().sum(-1)


def matched_giou(pred, target, scale):
    """gIoU of each query's box with its own target (cxcywh, scaled to
    pixels by ``scale`` (B, 1, 4)): (B, Q)."""
    a = cxcywh_to_xyxy(pred) * scale
    b = cxcywh_to_xyxy(target) * scale
    return torch.diagonal(generalized_box_iou(a, b), dim1=-2, dim2=-1)


def htri_cost(s_cls, o_cls, r_cls, s_box, o_box, gt_s_box, gt_o_box, gt_s_lbl, gt_o_lbl,
              gt_r_lbl, scale):
    """HTriMatcher's summed triplet costs (B, Q, R): class 1 + 1, predicate
    2, L1 5 on normalized boxes, gIoU 2 on image-scaled xyxy."""
    return (
        classification_cost(s_cls, gt_s_lbl)
        + classification_cost(o_cls, gt_o_lbl)
        + 2.0 * classification_cost(r_cls, gt_r_lbl)
        + 5.0 * (l1_cost(s_box, gt_s_box) + l1_cost(o_box, gt_o_box))
        + 2.0 * -generalized_box_iou(cxcywh_to_xyxy(s_box) * scale,
                                     cxcywh_to_xyxy(gt_s_box) * scale)
        + 2.0 * -generalized_box_iou(cxcywh_to_xyxy(o_box) * scale,
                                     cxcywh_to_xyxy(gt_o_box) * scale)
    )


def htri_match(s_cls, o_cls, r_cls, s_box, o_box, gt_s_box, gt_o_box, gt_s_lbl, gt_o_lbl,
               gt_r_lbl, rel_valid, image_shape):
    """HTriMatcher over a batch: relq2gt (B, Q), the GT triplet of each
    query or -1. Boxes normalized cxcywh; gIoU on image-scaled xyxy."""
    cost = htri_cost(s_cls, o_cls, r_cls, s_box, o_box, gt_s_box, gt_o_box, gt_s_lbl,
                     gt_o_lbl, gt_r_lbl, image_scale(image_shape))
    return batched_hungarian(cost, col_mask=rel_valid.bool())[0]


def weighted_ce(logits, labels, weights, avg, bg_index, bg_weight):
    """sum(nll * class_weight[label] * weights) / avg, the class weight
    ``bg_weight`` at ``bg_index`` and 1 elsewhere."""
    Cn = logits.shape[-1]
    lbl = labels.clamp(0, Cn - 1).long()
    cw = torch.ones(Cn, device=logits.device)
    cw[bg_index] = bg_weight
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    return torch.sum(nll * cw[lbl] * weights) / avg


def dice_full(pred, gt):
    """PSGTr's dice on full masks: 1 - (2 sum(p t) + 1) / (sum(p p) + sum(t t) + 1), (B, Q)."""
    p = torch.sigmoid(pred.float()).flatten(2)
    t = gt.float().flatten(2)
    num = 2.0 * (p * t).sum(-1)
    den = (p * p).sum(-1) + (t * t).sum(-1)
    return 1.0 - (num + 1.0) / (den + 1.0)


def take_rows(arr, idx):
    """arr (B, N, ...) at idx (B, M) -> (B, M, ...)."""
    rows = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[rows, idx]


def psgtr_loss(outputs, batch, num_classes=133, num_relations=56, bg_cls_weight=0.02,
               box_l1_weight=5.0, giou_weight=2.0, rel_weight=2.0, dice_weight=1.0,
               aux_layers=True, reduce=None):
    """Per-decoder-layer PSGTr losses (the last layer's untagged, the others
    ``d<i>.``), and ``loss_total``. ``batch`` holds the padded GT with
    ``gt_boxes`` (B, G, 4) xyxy in resized-image pixels and ``image_shape``
    (B, 2). The assignments of every layer are solved in one Hungarian call.
    ``reduce`` sums over the data-parallel ranks (every normalizer global)."""
    del num_relations  # the predicate count is the logits' width
    L = outputs["layers"]
    n_layers = len(L["sub"])
    layer_ids = list(range(n_layers)) if aux_layers else [n_layers - 1]
    gt_labels = batch["gt_labels"].long()
    gt_rels = batch["gt_rels"].long()
    G = gt_labels.shape[1]
    sub_gt = gt_rels[..., 0].clamp(0, G - 1)
    obj_gt = gt_rels[..., 1].clamp(0, G - 1)
    gt_boxes = normalize_boxes(batch["gt_boxes"], batch["image_shape"])
    gt_s_box, gt_o_box = take_rows(gt_boxes, sub_gt), take_rows(gt_boxes, obj_gt)
    gt_s_lbl, gt_o_lbl = torch.gather(gt_labels, 1, sub_gt), torch.gather(gt_labels, 1, obj_gt)
    gt_r = gt_rels[..., 2]
    scale = image_scale(batch["image_shape"])
    B, Rm = gt_r.shape

    with torch.no_grad():  # every layer's (layer, image) problems in one call
        nl = len(layer_ids)

        def cat(key):
            return torch.cat([L[key][li].detach() for li in layer_ids])

        cost = htri_cost(cat("sub"), cat("obj"), cat("rel"), cat("sub_box"), cat("obj_box"),
                         *(tile(t, nl) for t in (gt_s_box, gt_o_box, gt_s_lbl, gt_o_lbl, gt_r,
                                                 scale)))
        relq2gt_all = batched_hungarian(cost, col_mask=tile(batch["rel_valid"].bool(), nl))[0]

    losses = {}
    for n, li in enumerate(layer_ids):
        relq2gt = relq2gt_all[n * B:(n + 1) * B]
        s_cls, o_cls, r_cls = L["sub"][li], L["obj"][li], L["rel"][li]
        s_box, o_box = L["sub_box"][li], L["obj_box"][li]
        pos = relq2gt >= 0
        safe = relq2gt.clamp(0, Rm - 1)
        w = pos.float()
        n_pos = _global(w.sum(), reduce)
        npos = n_pos.clamp_min(1.0)
        nneg = world_count(pos.numel(), reduce) - n_pos
        s_lbl_t = torch.where(pos, torch.gather(gt_s_lbl, 1, safe), num_classes)
        o_lbl_t = torch.where(pos, torch.gather(gt_o_lbl, 1, safe), num_classes)
        r_lbl_t = torch.where(pos, torch.gather(gt_r, 1, safe), 0)
        ll = {
            "s_loss_cls": weighted_ce(s_cls, s_lbl_t, w, npos, -1, bg_cls_weight),
            "o_loss_cls": weighted_ce(o_cls, o_lbl_t, w, npos, -1, bg_cls_weight),
            "r_loss_cls": rel_weight * weighted_ce(
                r_cls, r_lbl_t, torch.ones_like(w),
                (npos + bg_cls_weight * nneg).clamp_min(1.0), 0, bg_cls_weight),
        }
        s_box_t, o_box_t = take_rows(gt_s_box, safe), take_rows(gt_o_box, safe)
        l1 = (s_box - s_box_t).abs().sum(-1) + (o_box - o_box_t).abs().sum(-1)
        ll["loss_bbox"] = box_l1_weight * torch.sum(l1 * w) / npos
        g_s = matched_giou(s_box, s_box_t, scale)
        g_o = matched_giou(o_box, o_box_t, scale)
        ll["loss_iou"] = giou_weight * torch.sum((2.0 - g_s - g_o) * w) / npos
        if li == n_layers - 1 and outputs.get("sub_seg") is not None:
            gt_masks = batch["gt_masks"]
            s_gt_m = take_rows(gt_masks, torch.gather(sub_gt, 1, safe))
            o_gt_m = take_rows(gt_masks, torch.gather(obj_gt, 1, safe))
            ll["s_loss_dice"] = dice_weight * torch.sum(
                dice_full(outputs["sub_seg"], s_gt_m) * w) / npos
            ll["o_loss_dice"] = dice_weight * torch.sum(
                dice_full(outputs["obj_seg"], o_gt_m) * w) / npos
        tag = "" if li == n_layers - 1 else f"d{li}."
        losses.update({f"{tag}{k}": v for k, v in ll.items()})
    losses["loss_total"] = sum(losses.values())
    return losses


# ------------------------------------------------------------------ inference


def psgtr_postprocess(outputs, image_index=None, num_things: int = 80):
    """Top-k over (query x predicate) probabilities; subject and object
    masks at sigmoid > 0.85; the panoptic map fused from the selected
    triplets' masks with the 0.85 keep rule (the class label must not be
    the last foreground class: the reference's quirk)."""
    from pairnet_torch.models.heads.pairnet_inference import (
        INSTANCE_OFFSET,
        NO_OBJ,
        TripletPrediction,
    )

    del num_things
    b = image_index
    get = (lambda x: x[b]) if b is not None else (lambda x: x)
    r_cls = get(outputs["rel"])
    Q, R1 = r_cls.shape
    R = R1 - 1
    dev = r_cls.device
    r_lgs = torch.softmax(r_cls.float(), dim=-1)
    flat = r_lgs[:, 1:].reshape(-1)
    idx = torch.topk(flat, Q).indices
    r_labels = idx % R + 1
    tri = torch.div(idx, R, rounding_mode="floor")

    def sm(x):
        return torch.softmax(x.float(), dim=-1)[:, :-1]

    s_prob = sm(get(outputs["sub"]))[tri]
    o_prob = sm(get(outputs["obj"]))[tri]
    s_labels = s_prob.argmax(-1) + 1
    o_labels = o_prob.argmax(-1) + 1
    s_seg = get(outputs["sub_seg"])[tri]
    o_seg = get(outputs["obj_seg"])[tri]
    masks = torch.cat([torch.sigmoid(s_seg) > 0.85, torch.sigmoid(o_seg) > 0.85])

    all_logits = torch.cat([s_seg, o_seg]).float()
    labels0 = torch.cat([s_labels, o_labels]) - 1
    scores = torch.cat([s_prob.amax(-1), o_prob.amax(-1)])
    keep = (labels0 != s_prob.shape[-1] - 1) & (scores > 0.85)
    flat_logits = torch.where(keep[:, None], all_logits.reshape(2 * Q, -1), float("-inf"))
    m_id = flat_logits.argmax(dim=0)
    pan = torch.where(keep.any(), m_id * INSTANCE_OFFSET + labels0[m_id],
                      INSTANCE_OFFSET + NO_OBJ).reshape(all_logits.shape[-2:])
    ar = torch.arange(Q, device=dev)
    return TripletPrediction(
        labels=torch.cat([s_labels, o_labels]),
        rel_pairs=torch.stack([ar, ar + Q], dim=-1),
        masks=masks,
        pan_seg=pan,
        r_dists=r_lgs[tri],
        r_labels=r_labels,
        r_scores=flat[idx],
    )
