"""Key-relation rankers and their weak supervision labels.

Counterpart of ``pairnet_tpu/models/heads/twostage/ranker.py``:
:class:`LinearRanker` (an MLP over union features), :class:`LSTMRanker` (an
LSTM over the pairs sorted by union-box x-center, invalid pairs last) and
:func:`get_weak_key_rel_labels` (saliency x area importance, softmaxed over
an image's pairs). No config uses them.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.heads.twostage.contexts import masked_lstm
from pairnet_torch.models.heads.twostage.core import take


class LinearRanker(nn.Module):
    """(B, P, D) union features -> (B, P) key-relation scores."""

    def __init__(self, in_dim: int, hidden_dim: int = 512, num_layers: int = 1):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(in_dim if i == 0 else hidden_dim, hidden_dim))
        self.num_layers = num_layers
        self.out = nn.Linear(hidden_dim, 1)

    def forward(self, union_feats, pair_valid=None):
        x = union_feats
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        score = self.out(x)[..., 0]
        if pair_valid is not None:
            score = torch.where(pair_valid, score, -1e9)
        return score


class LSTMRanker(nn.Module):
    """LSTM over the pairs sorted by union-box x-center, then a score head."""

    def __init__(self, in_dim: int, hidden_dim: int = 512):
        super().__init__()
        self.lstm = nn.LSTM(in_dim, hidden_dim, batch_first=True)
        self.out = nn.Linear(hidden_dim, 1)

    def forward(self, union_feats, union_boxes, pair_valid):
        cx = (union_boxes[..., 0] + union_boxes[..., 2]) / 2.0
        perm = torch.argsort(torch.where(pair_valid, cx, torch.inf), dim=-1, stable=True)
        inv = torch.argsort(perm, dim=-1, stable=True)
        h = masked_lstm(self.lstm, take(union_feats, perm), take(pair_valid, perm))
        score = self.out(take(h, inv).to(union_feats.dtype))[..., 0]
        return torch.where(pair_valid, score, -1e9)


def get_weak_key_rel_labels(saliency_map, boxes, pairs, pair_valid, comb_factor: float = 0.5):
    """Weak key-relation targets of one image: per object comb x mean box
    saliency + (1 - comb) x relative area; per pair the sum over its
    endpoints, softmaxed over the valid pairs. saliency (H, W), boxes (N, 4),
    pairs (P, 2), pair_valid (P,) -> (P,)."""
    H, W = saliency_map.shape
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)[None, None, :]
    b = boxes.float()[:, :, None, None]
    inside = ((xs >= b[:, 0]) & (xs <= b[:, 2]) & (ys >= b[:, 1]) & (ys <= b[:, 3])).float()
    area = inside.sum((1, 2)).clamp_min(1.0)
    sal = (saliency_map[None] * inside).sum((1, 2)) / area
    obj_imp = comb_factor * sal + (1.0 - comb_factor) * (area / (H * W))
    pair_imp = obj_imp[pairs[:, 0].long()] + obj_imp[pairs[:, 1].long()]
    return torch.softmax(torch.where(pair_valid, pair_imp, -1e9), -1)
