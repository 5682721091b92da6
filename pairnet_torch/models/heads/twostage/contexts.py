"""Two-stage context encoders: the MOTIFS bi-LSTM, IMP's GRU message
passing, GPS-Net's direction-aware message passing.

Counterpart of ``pairnet_tpu/models/heads/twostage/contexts.py``: objects
(B, N) and pairs (B, P) padded with masks.

* :func:`masked_lstm`: JAX scans a masked LSTM (invalid steps hold the
  carry and output 0) over objects sorted by :func:`sort_by_x`, which puts
  the invalid slots last. The valid steps are then a prefix, so the port
  runs ``nn.LSTM`` over packed sequences of the prefix lengths (flax's
  ``OptimizedLSTMCell`` has torch's gate order i, f, g, o); the reverse
  direction starts at each sequence's last valid step, as the masked
  reverse scan does. The prefix lengths reach the host (one sync a call).
* :class:`DecoderRNN`: the MOTIFS highway-LSTM label decoder, a loop of N
  steps feeding its argmax (or the teacher-forced label) to the next.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from pairnet_torch.models.heads.twostage.core import RunningBatchNorm, encode_box_info, take


def masked_lstm(lstm: nn.LSTM, x, mask):
    """``lstm`` (batch first) over x (B, N, D) whose valid steps ``mask``
    (B, N) are a prefix of each row; invalid steps output 0."""
    lengths = mask.sum(1)
    packed = pack_padded_sequence(x.to(lstm.weight_ih_l0.dtype), lengths.clamp_min(1).cpu(),
                                  batch_first=True, enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
    return out * mask[..., None].to(out.dtype)


def sort_by_x(boxes, valid):
    """Per-image left-to-right order (descending cx / (max cx + 1)) with the
    invalid slots last: (perm, inv_perm), each (B, N)."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    score = cx / (torch.where(valid, cx, 0.0).amax(1, keepdim=True) + 1.0)
    key = torch.where(valid, score, -torch.inf)
    perm = torch.argsort(-key, dim=1, stable=True)
    return perm, torch.argsort(perm, dim=1, stable=True)


def one_hot_labels(labels, C):
    return F.one_hot(labels.long().clamp(0, C - 1), C).float()


def pos_embed(box_dim=9):
    """Linear(9, 32) -> BN -> Linear(32, 128) -> ReLU (``pos_embed.{0,1,2}``)."""
    return nn.Sequential(nn.Linear(box_dim, 32), RunningBatchNorm(32), nn.Linear(32, 128),
                         nn.ReLU())


class DecoderRNN(nn.Module):
    """Sequential label decoder: the reference's highway LSTM
    (``input_linearity`` projects the input to six gate chunks i, f, g, o,
    highway gate, highway input; ``state_linearity`` the hidden state to
    five) whose input includes the embedding of the previous step's label:
    its own argmax over the foreground, or the teacher-forced label where
    one is given (> 0; -1 is the sentinel). The reference's per-class NMS
    inside the sgdet decode is left out, as in JAX."""

    def __init__(self, num_classes: int, in_dim: int, embed_dim: int = 200,
                 hidden_dim: int = 512):
        super().__init__()
        self.num_classes, self.hidden_dim = num_classes, hidden_dim
        self.obj_embed = nn.Embedding(num_classes + 1, embed_dim)
        self.input_linearity = nn.Linear(in_dim + embed_dim, 6 * hidden_dim)
        self.state_linearity = nn.Linear(hidden_dim, 5 * hidden_dim)
        self.out_obj = nn.Linear(hidden_dim, num_classes)

    def forward(self, x, mask, labels=None):  # x (B, N, D) sorted
        B, N, _ = x.shape
        H, C = self.hidden_dim, self.num_classes
        h = x.new_zeros((B, H))
        c = x.new_zeros((B, H))
        prev = torch.full((B,), -1, dtype=torch.long, device=x.device)
        dists, preds = [], []
        for t in range(N):
            mt = mask[:, t]
            inp = torch.cat([x[:, t], self.obj_embed.weight[(prev + 1).clamp(0, C)]], -1)
            pi = self.input_linearity(inp)
            ps = self.state_linearity(h)
            g = [pi[:, k * H:(k + 1) * H] + ps[:, k * H:(k + 1) * H] for k in range(5)]
            c_new = torch.sigmoid(g[0]) * torch.tanh(g[2]) + torch.sigmoid(g[1]) * c
            ht = torch.sigmoid(g[3]) * torch.tanh(c_new)
            hw = torch.sigmoid(g[4])
            ht = hw * ht + (1.0 - hw) * pi[:, 5 * H:6 * H]
            dist = self.out_obj(ht)
            pred = dist[:, 1:].argmax(-1) + 1
            nxt = pred if labels is None else torch.where(labels[:, t] > 0, labels[:, t].long(),
                                                          pred)
            h = torch.where(mt[:, None], ht, h)
            c = torch.where(mt[:, None], c_new, c)
            prev = torch.where(mt, nxt, prev)
            dists.append(dist)
            preds.append(torch.where(mt, prev, 0))
        return torch.stack(dists, 1), torch.stack(preds, 1)


class LSTMContext(nn.Module):
    """The MOTIFS context: object context bi-LSTM, the label decoder
    (sgcls / sgdet), the edge context bi-LSTM."""

    def __init__(self, num_classes: int, mode: str = "predcls", embed_dim: int = 200,
                 hidden_dim: int = 512, roi_dim: int = 1024):
        super().__init__()
        C, E, H = num_classes, embed_dim, hidden_dim
        self.num_classes, self.mode = C, mode
        self.obj_embed1 = nn.Embedding(C, E)
        self.obj_embed2 = nn.Embedding(C, E)
        self.pos_embed = pos_embed()
        obj_in = roi_dim + E + 128
        self.obj_ctx_rnn = nn.LSTM(obj_in, H, batch_first=True, bidirectional=True)
        self.lin_obj_h = nn.Linear(2 * H, H)
        if mode != "predcls":
            self.decoder_rnn = DecoderRNN(C, obj_in + H, E, H)
        self.edge_ctx_rnn = nn.LSTM(E + roi_dim + H, H, batch_first=True, bidirectional=True)
        self.lin_edge_h = nn.Linear(2 * H, H)

    def forward(self, roi_feats, boxes, valid, img_hw, labels=None, dists=None):
        """-> (obj_dists (B, N, C), obj_preds (B, N), edge_ctx (B, N, H))."""
        C = self.num_classes
        if self.mode == "predcls":
            emb = self.obj_embed1.weight[labels.long().clamp(0, C - 1)]
        else:
            emb = dists.detach().to(roi_feats.dtype) @ self.obj_embed1.weight
        pos = self.pos_embed(encode_box_info(boxes, img_hw).to(roi_feats.dtype))
        obj_pre = torch.cat([roi_feats, emb, pos], -1)
        perm, inv = sort_by_x(boxes, valid)
        sorted_feats = take(obj_pre, perm)
        sorted_mask = take(valid, perm)
        enc = self.lin_obj_h(masked_lstm(self.obj_ctx_rnn, sorted_feats, sorted_mask)
                             .to(roi_feats.dtype))
        if self.mode == "predcls":
            obj_preds = labels
            obj_dists = one_hot_labels(labels, C)
        else:
            sorted_labels = None if labels is None else take(labels, perm)
            d_dists, d_preds = self.decoder_rnn(torch.cat([sorted_feats, enc], -1), sorted_mask,
                                                sorted_labels)
            obj_dists, obj_preds = take(d_dists, inv), take(d_preds, inv)
        emb2 = self.obj_embed2.weight[obj_preds.long().clamp(0, C - 1)]
        edge_in = torch.cat([emb2, roi_feats, take(enc, inv)], -1)
        edge = masked_lstm(self.edge_ctx_rnn, take(edge_in, perm), sorted_mask)
        edge_ctx = take(self.lin_edge_h(edge.to(roi_feats.dtype)), inv)
        return obj_dists, obj_preds, edge_ctx


def _gate(in_dim):
    return nn.Sequential(nn.Linear(in_dim, 1))  # the reference's Sequential(Linear, Sigmoid)


class IMPContext(nn.Module):
    """Iterative message passing: node and edge GRUs, edge messages gated
    on the endpoint states, node messages as the scatter-sum
    (``index_add_``) of gated edge states over the valid pairs."""

    def __init__(self, num_classes: int, num_predicates: int, in_dim: int = 1024,
                 hidden_dim: int = 512, num_iter: int = 2, mode: str = "predcls"):
        super().__init__()
        H = hidden_dim
        self.num_classes, self.num_iter, self.mode = num_classes, num_iter, mode
        self.obj_unary = nn.Linear(in_dim, H)
        self.edge_unary = nn.Linear(in_dim, H)
        self.node_gru = nn.GRUCell(H, H)
        self.edge_gru = nn.GRUCell(H, H)
        self.sub_vert_w_fc = _gate(2 * H)
        self.obj_vert_w_fc = _gate(2 * H)
        self.out_edge_w_fc = _gate(2 * H)
        self.in_edge_w_fc = _gate(2 * H)
        if mode != "predcls":
            self.obj_fc = nn.Linear(H, num_classes)
        self.rel_fc = nn.Linear(H, num_predicates)

    @staticmethod
    def _gru(cell, inputs, hidden):
        shape = inputs.shape
        return cell(inputs.reshape(-1, shape[-1]), hidden.reshape(-1, shape[-1])).reshape(shape)

    def forward(self, roi_feats, union_feats, pairs, obj_valid, pair_valid, labels=None):
        """roi_feats (B, N, D); union_feats (B, P, D); pairs (B, P, 2)."""
        B, N, _ = roi_feats.shape
        obj_rep = self.obj_unary(roi_feats)
        rel_rep = F.relu(self.edge_unary(union_feats))
        H = obj_rep.shape[-1]
        sub_idx, obj_idx = pairs[..., 0].long(), pairs[..., 1].long()
        pv = pair_valid[..., None].to(obj_rep.dtype)
        vert = self._gru(self.node_gru, obj_rep, torch.zeros_like(obj_rep))
        edge = self._gru(self.edge_gru, rel_rep, torch.zeros_like(rel_rep))
        base = (torch.arange(B, device=pairs.device) * N)[:, None]
        for _ in range(self.num_iter):
            sub_h, obj_h = take(vert, sub_idx), take(vert, obj_idx)
            w_s = torch.sigmoid(self.sub_vert_w_fc(torch.cat([sub_h, edge], -1)))
            w_o = torch.sigmoid(self.obj_vert_w_fc(torch.cat([obj_h, edge], -1)))
            new_edge = self._gru(self.edge_gru, w_s * sub_h + w_o * obj_h, edge)
            pre_out = torch.sigmoid(self.out_edge_w_fc(torch.cat([sub_h, edge], -1))) * edge * pv
            pre_in = torch.sigmoid(self.in_edge_w_fc(torch.cat([obj_h, edge], -1))) * edge * pv
            vert_ctx = vert.new_zeros((B * N, H))
            vert_ctx = vert_ctx.index_add(0, (base + sub_idx).reshape(-1), pre_out.reshape(-1, H))
            vert_ctx = vert_ctx.index_add(0, (base + obj_idx).reshape(-1), pre_in.reshape(-1, H))
            vert = self._gru(self.node_gru, vert_ctx.reshape(B, N, H), vert)
            edge = new_edge
        if self.mode == "predcls" and labels is not None:
            obj_dists = one_hot_labels(labels, self.num_classes)
        else:
            obj_dists = self.obj_fc(vert)
        return obj_dists, self.rel_fc(edge)


class DMPContext(nn.Module):
    """GPS-Net's direction-aware message passing on the valid subgraph:
    attention = sigmoid of the scattered pair coefficients with a zero
    diagonal, masked to the valid objects and row-normalized; context =
    [A @ W_t3(x), A^T @ W_t3(x)] -> trans; features relu(x + trans)."""

    def __init__(self, num_classes: int, in_dim: int = 1024, embed_dim: int = 200,
                 obj_dim: int = 1024, mode: str = "predcls"):
        super().__init__()
        C, E, D = num_classes, embed_dim, obj_dim
        self.num_classes, self.mode = C, mode
        self.obj_embed = nn.Embedding(C, E)
        self.pos_embed = pos_embed()
        self.project_input = nn.Sequential(nn.Linear(in_dim + E + 128, D), nn.ReLU())
        self.ws = nn.Linear(D, D)
        self.wo = nn.Linear(D, D)
        self.wu = nn.Linear(in_dim, D)
        self.w = nn.Linear(D, 1)
        self.W_t3 = nn.Sequential(nn.Linear(D, D // 2), nn.ReLU())
        self.trans = nn.Sequential(nn.Linear(D, D // 4), nn.LayerNorm(D // 4, eps=1e-5),
                                   nn.ReLU(), nn.Linear(D // 4, D))
        if mode != "predcls":
            self.out_obj = nn.Linear(D, C)

    def forward(self, roi_feats, union_feats, pairs, boxes, valid, pair_valid, img_hw,
                labels=None, dists=None):
        C = self.num_classes
        if self.mode == "predcls" and labels is not None:
            emb = self.obj_embed.weight[labels.long().clamp(0, C - 1)]
        else:
            emb = dists.detach().to(roi_feats.dtype) @ self.obj_embed.weight
        pos = self.pos_embed(encode_box_info(boxes, img_hw).to(roi_feats.dtype))
        x = self.project_input(torch.cat([roi_feats, emb, pos], -1))
        B, N, _ = x.shape
        coeff = self.w(self.ws(take(x, pairs[..., 0])) * self.wo(take(x, pairs[..., 1]))
                       * self.wu(union_feats))[..., 0]  # (B, P)
        flat = pairs[..., 0].long() * N + pairs[..., 1].long()
        a = coeff.new_zeros((B, N * N)).scatter_add(1, flat, torch.where(pair_valid, coeff, 0.0))
        eye = torch.eye(N, dtype=a.dtype, device=a.device)
        a = torch.sigmoid(a.reshape(B, N, N)) * (1.0 - eye)
        vm = valid.to(a.dtype)
        a = a * vm[:, :, None] * vm[:, None, :]
        attn = a / a.sum(2, keepdim=True).clamp_min(1e-6)
        t3 = self.W_t3(x)
        ctx = torch.cat([attn @ t3, attn.transpose(1, 2) @ t3], -1)
        x = F.relu(x + self.trans(ctx)) * valid[..., None].to(x.dtype)
        if self.mode == "predcls" and labels is not None:
            obj_dists = one_hot_labels(labels, C)
        else:
            obj_dists = self.out_obj(x)
        return obj_dists, x
