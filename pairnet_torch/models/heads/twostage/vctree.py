"""VCTree context and head (the reference's binary TreeLSTMs).

Counterpart of ``pairnet_tpu/models/heads/twostage/vctree.py``:

* relatedness = sigmoid(vision_prior([sub * obj, sub, obj])) over a score
  stack fed by detached reduced roi / embedding features and box / overlap
  embeddings;
* :func:`gen_vctree_binary`: the greedy max-score tree (root = argmax of the
  row means, then the best (selected, remaining) edge at each step, the
  first maximum of the flat scores) as a left-child / right-sibling binary
  tree, batched over the images;
* bidirectional binary TreeLSTMs and a root-to-leaves decoder that passes
  predicted-label embeddings down the tree, as masked level sweeps over the
  parent / child pointers (N levels each way, as JAX sweeps them; the input
  projections, which no level changes, are computed once);
* MOTIFS-style post decode and the auxiliary binary loss on the
  relatedness.

Module names are the reference's
(``obj_ctx_rnn.multi_layer_lstm.0.treeLSTM_foreward.treeLSTM.*``,
``decoder_rnn.decoderLSTM.*``), so ``convert_vctree_head`` reads them.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.heads.twostage.contexts import one_hot_labels, pos_embed
from pairnet_torch.models.heads.twostage.core import RunningBatchNorm, encode_box_info, take
from pairnet_torch.models.heads.twostage.heads import _PostDecode
from pairnet_torch.ops.boxes import box_iou


def overlap_info(boxes, valid):
    """(B, N, 6) overlap statistics per object: [sum IoU, #overlaps, mean
    overlap, x-extent frac, y-extent frac, area frac]."""
    N = boxes.shape[1]
    eye = torch.eye(N, dtype=boxes.dtype, device=boxes.device)
    iou = box_iou(boxes, boxes)[0] * (1.0 - eye) * valid[:, None, :].to(boxes.dtype)
    overlaps = (iou > 0).to(boxes.dtype)
    bw = (boxes[..., 2] - boxes[..., 0]).clamp_min(0)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    area = bw * bh
    total = area.sum(1, keepdim=True).clamp_min(1.0)
    return torch.stack([iou.sum(2), overlaps.sum(2), iou.sum(2) / overlaps.sum(2).clamp_min(1.0),
                        bw / torch.sqrt(total), bh / torch.sqrt(total), area / total], -1)


def gen_vctree_binary(scores, valid):
    """scores (B, N, N) relatedness, valid (B, N) -> (bi_left, bi_right,
    bi_parent), each (B, N) int64 with -1 for none. Children keep their
    insertion order: the first child is the binary left child, later ones
    chain as right siblings."""
    B, N, _ = scores.shape
    dev = scores.device
    bidx = torch.arange(B, device=dev)
    neg = -torch.inf
    nvalid = valid.sum(1).clamp_min(1)
    node_scores = torch.where(valid, torch.where(valid[:, None, :], scores, 0.0).sum(2), neg)
    node_scores = torch.where(valid, node_scores / nvalid[:, None], neg)  # the unpadded row mean
    root = node_scores.argmax(1)
    selected = torch.zeros((B, N), dtype=torch.bool, device=dev)
    selected[bidx, root] = True
    bi_left, bi_right, bi_parent, last_child = (
        torch.full((B, N), -1, dtype=torch.long, device=dev) for _ in range(4))
    for _ in range(N - 1):
        cand = torch.where(selected[:, :, None] & ~selected[:, None, :] & valid[:, None, :],
                           scores, neg).reshape(B, -1)
        flat = cand.argmax(1)  # the first maximum
        i, j = flat // N, flat % N
        ok = cand[bidx, flat] > neg
        lc = last_child[bidx, i]
        has_child = lc >= 0
        prev = lc.clamp(0, N - 1)
        bi_left[bidx, i] = torch.where(ok & ~has_child, j, bi_left[bidx, i])
        bi_right[bidx, prev] = torch.where(ok & has_child, j, bi_right[bidx, prev])
        bi_parent[bidx, j] = torch.where(ok, torch.where(has_child, prev, i), bi_parent[bidx, j])
        last_child[bidx, i] = torch.where(ok, j, lc)
        selected[bidx, j] = selected[bidx, j] | ok
    return bi_left, bi_right, bi_parent


def tree_depths(parent):
    """(B, N) depth of each node from its parent pointers."""
    B, N = parent.shape
    d = torch.zeros_like(parent)
    a = torch.arange(N, device=parent.device).expand(B, N)
    for _ in range(N):
        pa = torch.gather(parent, 1, a)
        moved = pa >= 0
        d = d + moved.long()
        a = torch.where(moved, pa, a)
    return d


def _at(h, idx):
    """h (B, N, H) at the pointers idx (B, N); zero where idx < 0."""
    return torch.where((idx >= 0)[..., None], take(h, idx.clamp_min(0)), 0.0)


class BiFwdTreeCell(nn.Module):
    """Leaves-to-root cell: gates (i, o, f_l, f_r, u, r) from the input and
    separate left / right child hidden projections; highway mix with px."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.px = nn.Linear(in_dim, hidden)
        self.ioffux = nn.Linear(in_dim, 6 * hidden)
        self.ioffuh_left = nn.Linear(hidden, 6 * hidden)
        self.ioffuh_right = nn.Linear(hidden, 6 * hidden)

    def step(self, zx, px, lh, lc, rh, rc):
        i, o, f_l, f_r, u, r = (zx + self.ioffuh_left(lh) + self.ioffuh_right(rh)).chunk(6, -1)
        c = torch.sigmoid(i) * torch.tanh(u) + torch.sigmoid(f_l) * lc + torch.sigmoid(f_r) * rc
        h = torch.sigmoid(o) * torch.tanh(c)
        r = torch.sigmoid(r)
        return r * h + (1.0 - r) * px, c


class BiBwdTreeCell(nn.Module):
    """Root-to-leaves cell: gates (i, o, f, u, r) from the input and the
    binary parent's hidden state; highway mix with px."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.px = nn.Linear(in_dim, hidden)
        self.iofux = nn.Linear(in_dim, 5 * hidden)
        self.iofuh = nn.Linear(hidden, 5 * hidden)

    def step(self, zx, px, ph, pc):
        i, o, f, u, r = (zx + self.iofuh(ph)).chunk(5, -1)
        c = torch.sigmoid(i) * torch.tanh(u) + torch.sigmoid(f) * pc
        h = torch.sigmoid(o) * torch.tanh(c)
        r = torch.sigmoid(r)
        return r * h + (1.0 - r) * px, c


class _TreeLSTMSlot(nn.Module):
    """The reference's ``treeLSTM_foreward`` / ``treeLSTM_backward`` wrapper."""

    def __init__(self, cell):
        super().__init__()
        self.treeLSTM = cell


class _BiTreeLayer(nn.Module):
    def __init__(self, in_dim, half):
        super().__init__()
        self.treeLSTM_foreward = _TreeLSTMSlot(BiFwdTreeCell(in_dim, half))
        self.treeLSTM_backward = _TreeLSTMSlot(BiBwdTreeCell(in_dim, half))


class BiTreeLSTM(nn.Module):
    """Bidirectional binary TreeLSTM, each direction hidden / 2."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.half = hidden // 2
        self.multi_layer_lstm = nn.ModuleList([_BiTreeLayer(in_dim, self.half)])

    def forward(self, x, bi_left, bi_right, bi_parent, valid):
        layer = self.multi_layer_lstm[0]
        fwd, bwd = layer.treeLSTM_foreward.treeLSTM, layer.treeLSTM_backward.treeLSTM
        N = x.shape[1]
        depth = tree_depths(bi_parent)
        zx, px = fwd.ioffux(x), fwd.px(x)
        h = x.new_zeros((*x.shape[:2], self.half))
        c = torch.zeros_like(h)
        for lvl in range(N - 1, -1, -1):  # leaves to root
            sel = ((depth == lvl) & valid)[..., None]
            h_new, c_new = fwd.step(zx, px, _at(h, bi_left), _at(c, bi_left), _at(h, bi_right),
                                    _at(c, bi_right))
            h, c = torch.where(sel, h_new, h), torch.where(sel, c_new, c)
        h_f = h
        zx, px = bwd.iofux(x), bwd.px(x)
        h = torch.zeros_like(h_f)
        c = torch.zeros_like(h_f)
        for lvl in range(N):  # root to leaves
            sel = ((depth == lvl) & valid)[..., None]
            h_new, c_new = bwd.step(zx, px, _at(h, bi_parent), _at(c, bi_parent))
            h, c = torch.where(sel, h_new, h), torch.where(sel, c_new, c)
        return torch.cat([h_f, h], -1)


class DecoderTreeCell(nn.Module):
    """Root-to-leaves decoder: input = [feature, parent label embedding];
    each node commits the argmax over the foreground, embedded as label + 1
    for its binary children (the root takes embedding row 0)."""

    def __init__(self, num_classes: int, in_dim: int, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.num_classes, self.hidden_dim = num_classes, hidden_dim
        self.obj_embed = nn.Embedding(num_classes + 1, embed_dim)
        self.decoderLSTM = BiBwdTreeCell(in_dim + embed_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, num_classes)

    def forward(self, x, bi_parent, valid):
        B, N, _ = x.shape
        C = self.num_classes
        cell, embed = self.decoderLSTM, self.obj_embed.weight
        depth = tree_depths(bi_parent)
        has_par = (bi_parent >= 0)[..., None]
        h = x.new_zeros((B, N, self.hidden_dim))
        c = torch.zeros_like(h)
        lbl = torch.zeros((B, N), dtype=torch.long, device=x.device)
        dists = x.new_zeros((B, N, C))
        for lvl in range(N):
            sel = (depth == lvl) & valid
            par_lbl = take(lbl, bi_parent.clamp_min(0))
            par_embed = torch.where(has_par, embed[(par_lbl + 1).clamp(0, C)], embed[0])
            inp = torch.cat([x, par_embed], -1)
            h_new, c_new = cell.step(cell.iofux(inp), cell.px(inp), _at(h, bi_parent),
                                     _at(c, bi_parent))
            dist = self.out(h_new)
            pred = dist[..., 1:].argmax(-1) + 1
            h = torch.where(sel[..., None], h_new, h)
            c = torch.where(sel[..., None], c_new, c)
            lbl = torch.where(sel, pred, lbl)
            dists = torch.where(sel[..., None], dist, dists)
        return dists, lbl


class VCTreeContext(nn.Module):
    """Relatedness scores -> binary VCTree -> BiTreeLSTM contexts."""

    def __init__(self, num_classes: int, mode: str = "predcls", embed_dim: int = 200,
                 hidden_dim: int = 512, roi_dim: int = 1024):
        super().__init__()
        C, E, H = num_classes, embed_dim, hidden_dim
        self.num_classes, self.mode = C, mode
        self.obj_embed1 = nn.Embedding(C, E)
        self.obj_embed2 = nn.Embedding(C, E)
        self.pos_embed = pos_embed()
        self.box_embed = nn.Sequential(nn.Linear(9, 128), RunningBatchNorm(128), nn.ReLU())
        self.overlap_embed = nn.Sequential(nn.Linear(6, 128), RunningBatchNorm(128), nn.ReLU())
        self.obj_reduce = nn.Linear(roi_dim, 128)
        self.emb_reduce = nn.Linear(E, 128)
        self.score_pre = nn.Linear(512, H)
        self.score_sub = nn.Linear(H, H)
        self.score_obj = nn.Linear(H, H)
        self.vision_prior = nn.Linear(3 * H, 1)
        obj_in = roi_dim + E + 128
        self.obj_ctx_rnn = BiTreeLSTM(obj_in, H)
        if mode != "predcls":
            self.decoder_rnn = DecoderTreeCell(C, obj_in + H, E, H)
        self.edge_ctx_rnn = BiTreeLSTM(E + roi_dim + H, H)

    def forward(self, roi_feats, boxes, valid, img_hw, labels=None, dists=None):
        C = self.num_classes
        relu = torch.relu
        if self.mode == "predcls" and labels is not None:
            emb = self.obj_embed1.weight[labels.long().clamp(0, C - 1)]
        else:
            emb = dists.detach().to(roi_feats.dtype) @ self.obj_embed1.weight
        pos9 = encode_box_info(boxes, img_hw).to(roi_feats.dtype)
        pos = self.pos_embed(pos9)
        # the score stack reads detached inputs
        box_e = self.box_embed(pos9)
        ov_e = self.overlap_embed(overlap_info(boxes, valid).to(roi_feats.dtype))
        pre = relu(self.score_pre(torch.cat([self.obj_reduce(roi_feats.detach()),
                                             self.emb_reduce(emb.detach()), box_e, ov_e], -1)))
        sub = relu(self.score_sub(pre))
        obj = relu(self.score_obj(pre))
        B, N, H = sub.shape
        prior_in = torch.cat([sub[:, :, None] * obj[:, None, :],
                              sub[:, :, None].expand(B, N, N, H),
                              obj[:, None, :].expand(B, N, N, H)], -1)
        bi_logits = self.vision_prior(prior_in)[..., 0]  # (B, N, N)
        trees = gen_vctree_binary(torch.sigmoid(bi_logits).detach().float(), valid)
        bi_left, bi_right, bi_parent = trees

        obj_pre = torch.cat([roi_feats, emb, pos], -1)
        enc = self.obj_ctx_rnn(obj_pre, bi_left, bi_right, bi_parent, valid)
        if self.mode == "predcls" and labels is not None:
            obj_preds = labels
            obj_dists = one_hot_labels(labels, C)
        else:
            obj_dists, obj_preds = self.decoder_rnn(torch.cat([obj_pre, enc], -1), bi_parent,
                                                    valid)
        emb2 = self.obj_embed2.weight[obj_preds.long().clamp(0, C - 1)]
        edge_ctx = self.edge_ctx_rnn(torch.cat([emb2, roi_feats, enc], -1), bi_left, bi_right,
                                     bi_parent, valid)
        return obj_dists, obj_preds, edge_ctx, bi_logits


class VCTreeHead(_PostDecode):
    """MOTIFS-style post decode over VCTree contexts (+ the binary tree loss)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.context_layer = VCTreeContext(self.num_classes, mode=self.mode,
                                           embed_dim=self.embed_dim, hidden_dim=self.hidden_dim,
                                           roi_dim=self.roi_dim)

    def predict(self, roi_feats, union_feats, batch):
        obj_dists, obj_preds, edge_ctx, rel_mat = self.context_layer(
            roi_feats, batch["det_boxes"].float(), batch["det_valid"], batch["image_shape"],
            labels=batch.get("det_labels"),
            dists=None if self.mode == "predcls" else self.det_dists(batch))
        return {"refine_scores": obj_dists, "obj_preds": obj_preds,
                "rel_scores": self.post_decode(edge_ctx, obj_preds, union_feats, batch),
                "relatedness": torch.sigmoid(rel_mat)}


def vctree_binary_loss(relatedness, batch, reduce=None):
    """Binary CE of the relatedness (B, N, N) against the GT-related sampled
    pairs, over the valid object pairs. ``reduce`` sums the normalizer over
    the data-parallel ranks (None: world size 1)."""
    from pairnet_torch.models.losses import _global

    B, N, _ = relatedness.shape
    pairs = batch["pairs"].long()
    pos = ((batch["pair_labels"] > 0) & batch["pair_valid"]).float()
    gt = relatedness.new_zeros((B, N * N), dtype=torch.float32).scatter_reduce(
        1, pairs[..., 0] * N + pairs[..., 1], pos, reduce="amax").reshape(B, N, N)
    dv = batch["det_valid"]
    vmask = (dv[:, :, None] & dv[:, None, :]).float()
    p = relatedness.float().clamp(1e-6, 1 - 1e-6)
    bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
    return torch.sum(bce * vmask) / _global(vmask.sum(), reduce).clamp_min(1.0)
