"""Matrix learners of the Pair Proposal Network.

Counterpart of ``pairnet_tpu/models/heads/matrix_learner.py`` (reference
``cnn_factory.py``, ``attn.py``, ``fc.py``): each refines the (B, Q, Q)
affinity logits and returns the same shape.

* ``conv_tiny``: three 7x7 convolutions 1 -> 64 -> 64 -> 1 with ReLU
  between, at ``conv_layers.<i>.0`` (the reference checkpoint's names).
* ``conv_small``: a ConvNeXt-like block with a residual: 7x7 conv,
  depthwise 7x7, LayerNorm over channels, 1x1 -> 4x GELU 1x1, 7x7 out.
* ``conv_base``: a small U-Net (GroupNorm(8) blocks, 2x2 average pools,
  nearest 2x upsampling cropped to the skip's extent).
* ``attn``: per-cell embedding, attention along rows then columns.
* ``fc``: a 7-layer MLP over affinity rows.

The four ablation mappers have no reference checkpoint keys, so their
modules carry the flax module names. Every mapper computes in its input's
type, as flax promotes an f32 affinity against bf16 weights to f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.layers import LN_EPS, MultiheadAttention


def _conv(layer: nn.Conv2d, y):
    """``layer`` in ``y``'s type."""
    bias = None if layer.bias is None else layer.bias.to(y.dtype)
    return F.conv2d(y, layer.weight.to(y.dtype), bias, padding=layer.padding,
                    groups=layer.groups)


def _linear(layer: nn.Linear, y):
    return F.linear(y, layer.weight.to(y.dtype), layer.bias.to(y.dtype))


def _conv2d(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ConvTiny(nn.Module):
    def __init__(self, mid_channels=64, kernel_size=7):
        super().__init__()
        chans = (1, mid_channels, mid_channels, 1)
        self.conv_layers = nn.ModuleList(
            [nn.Sequential(_conv2d(chans[i], chans[i + 1], kernel_size)) for i in range(3)]
        )

    def forward(self, x):  # (B, Q, Q)
        y = x[:, None]
        for i, seq in enumerate(self.conv_layers):
            y = _conv(seq[0], y)
            if i < 2:
                y = F.relu(y)
        return y[:, 0]


class ConvSmall(nn.Module):
    def __init__(self, dim=96):
        super().__init__()
        self.in_conv = _conv2d(1, dim, 7)
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Conv2d(dim, 4 * dim, 1)
        self.pwconv2 = nn.Conv2d(4 * dim, dim, 1)
        self.out_conv = _conv2d(dim, 1, 7)

    def forward(self, x):
        inp = x[:, None]
        y = _conv(self.dwconv, _conv(self.in_conv, inp))
        n = self.norm
        y = F.layer_norm(y.permute(0, 2, 3, 1), n.normalized_shape, n.weight.to(y.dtype),
                         n.bias.to(y.dtype), n.eps).permute(0, 3, 1, 2)
        y = _conv(self.pwconv2, F.gelu(_conv(self.pwconv1, y)))
        return (_conv(self.out_conv, y) + inp)[:, 0]


class ConvBase(nn.Module):
    BLOCKS = ("down1", "down2", "mid", "up2", "up1")

    def __init__(self, base=64):
        super().__init__()
        ins = (1, base, 2 * base, 6 * base, 3 * base)
        outs = (base, 2 * base, 4 * base, 2 * base, base)
        for name, cin, cout in zip(self.BLOCKS, ins, outs):
            self.add_module(f"{name}_c1", _conv2d(cin, cout, 3))
            self.add_module(f"{name}_gn", nn.GroupNorm(8, cout, eps=LN_EPS))
            self.add_module(f"{name}_c2", _conv2d(cout, cout, 3))
        self.out = nn.Conv2d(base, 1, 1)

    def _block(self, z, name):
        gn = getattr(self, f"{name}_gn")
        z = _conv(getattr(self, f"{name}_c1"), z)
        z = F.relu(F.group_norm(z, gn.num_groups, gn.weight.to(z.dtype), gn.bias.to(z.dtype),
                                gn.eps))
        return F.relu(_conv(getattr(self, f"{name}_c2"), z))

    @staticmethod
    def _up(z, skip):
        """Nearest 2x upsampling cropped to ``skip``'s extent, then ``skip``."""
        z = z.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return torch.cat([z[:, :, : skip.shape[2], : skip.shape[3]], skip], dim=1)

    def forward(self, x):
        d1 = self._block(x[:, None], "down1")
        d2 = self._block(F.avg_pool2d(d1, 2), "down2")
        mid = self._block(F.avg_pool2d(d2, 2), "mid")
        u2 = self._block(self._up(mid, d2), "up2")
        u1 = self._block(self._up(u2, d1), "up1")
        return _conv(self.out, u1)[:, 0]


class AttnMapper(nn.Module):
    def __init__(self, dim=64, num_heads=4):
        super().__init__()
        self.dim = dim
        self.in_proj = nn.Linear(1, dim)
        self.row_attn = MultiheadAttention(dim, num_heads)
        self.col_attn = MultiheadAttention(dim, num_heads)
        self.out_proj = nn.Linear(dim, 1)

    def forward(self, x):  # (B, Q, Q)
        B, Q, _ = x.shape
        d = self.dim
        rows = _linear(self.in_proj, x[..., None]).reshape(B * Q, Q, d)
        rows = rows + self.row_attn(rows, rows, rows)
        y = rows.reshape(B, Q, Q, d).transpose(1, 2).reshape(B * Q, Q, d)
        y = y + self.col_attn(y, y, y)
        return _linear(self.out_proj, y.reshape(B, Q, Q, d).transpose(1, 2))[..., 0]


class FCMapper(nn.Module):
    def __init__(self, num_queries=100, hidden=512, num_layers=7):
        super().__init__()
        dims = [num_queries] + [hidden] * (num_layers - 1) + [num_queries]
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):  # (B, Q, Q)
        y = x
        for i in range(self.num_layers):
            y = _linear(getattr(self, f"fc{i}"), y)
            if i < self.num_layers - 1:
                y = F.relu(y)
        return y


MAPPERS = {
    "conv_tiny": ConvTiny,
    "conv_small": ConvSmall,
    "conv_base": ConvBase,
    "attn": AttnMapper,
    "fc": FCMapper,
}


def create_mapper(name: str, num_queries: int, **kwargs) -> nn.Module:
    """The matrix learner ``name`` for a (Q, Q) affinity of ``num_queries``
    (the FC mapper's widths depend on it; flax infers them at init)."""
    if name not in MAPPERS:
        raise KeyError(f"unknown matrix learner '{name}', have {sorted(MAPPERS)}")
    if name == "fc":
        kwargs["num_queries"] = num_queries
    return MAPPERS[name](**kwargs)
