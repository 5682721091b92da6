"""Plain PyTorch reference of Pair-Net (R-50 or Swin-B backbone), written
as functions over a state dict.

It follows the published architecture (Pair-Net, T-PAMI 2024: a ResNet or
Swin backbone, Mask2Former's MSDeformAttn pixel decoder and masked-attention
decoder, the Pair Proposal Network with its ConvTiny matrix learner and the
Relation Fusion decoder) and names every tensor as the reference
checkpoints do (torchvision ResNet, mmdet Swin and Mask2Former), so one
state dict loads into the system under test and feeds this module. It
imports nothing of the system under test.

Every product runs in float32 (the caller turns TF32 off). ``rnd`` is
applied to both operands of every product (linear, convolution, attention,
einsum); the identity gives the float32 reference, an fp8 rounding gives
the control of the correctness check.

:func:`param_specs` lists each tensor with its shape and how the
benchmark's initialiser fills it; :func:`forward` is the head's forward;
the deformable attention samples with ``grid_sample`` (align_corners
False, zero padding): a location p in [0, 1] reads pixel ``p * size - 0.5``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6  # LayerNorm / GroupNorm epsilon of the published configs' flax port
BN_EPS = 1e-5
RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def identity(t):
    return t


# ---------------------------------------------------------------- specs


class Specs(list):
    """(name, shape, kind) triples; ``kind`` tells the initialiser how to
    fill the tensor (see ``reference/init.py``). ``norms`` holds the names
    of the norms' affine parameters (no weight decay), ``buffers`` the
    frozen BatchNorms' tensors (not parameters)."""

    def __init__(self):
        super().__init__()
        self.norms, self.buffers = set(), set()

    def add(self, name, shape, kind):
        self.append((name, tuple(int(s) for s in shape), kind))

    def linear(self, name, cin, cout, bias=True, kind="fan_in"):
        self.add(f"{name}.weight", (cout, cin), kind)
        if bias:
            self.add(f"{name}.bias", (cout,), "zero")

    def conv(self, name, cin, cout, k, bias=True):
        self.add(f"{name}.weight", (cout, cin, k, k), "fan_in")
        if bias:
            self.add(f"{name}.bias", (cout,), "zero")

    def norm(self, name, c):
        self.add(f"{name}.weight", (c,), "one")
        self.add(f"{name}.bias", (c,), "zero")
        self.norms |= {f"{name}.weight", f"{name}.bias"}

    def frozen_bn(self, name, c):
        self.add(f"{name}.weight", (c,), "one")
        self.add(f"{name}.bias", (c,), "zero")
        self.add(f"{name}.running_mean", (c,), "zero")
        self.add(f"{name}.running_var", (c,), "one")
        self.buffers |= {f"{name}.{t}" for t in ("weight", "bias", "running_mean", "running_var")}


def resnet_specs(s: Specs, depth=50, base_width=64):
    s.conv("backbone.conv1", 3, base_width, 7, bias=False)
    s.frozen_bn("backbone.bn1", base_width)
    inplanes, planes, outs = base_width, base_width, []
    for stage, n in enumerate(RESNET_BLOCKS[depth]):
        for b in range(n):
            p = f"backbone.layer{stage + 1}.{b}"
            s.conv(f"{p}.conv1", inplanes, planes, 1, bias=False)
            s.frozen_bn(f"{p}.bn1", planes)
            s.conv(f"{p}.conv2", planes, planes, 3, bias=False)
            s.frozen_bn(f"{p}.bn2", planes)
            s.conv(f"{p}.conv3", planes, planes * 4, 1, bias=False)
            s.frozen_bn(f"{p}.bn3", planes * 4)
            if b == 0:
                s.conv(f"{p}.downsample.0", inplanes, planes * 4, 1, bias=False)
                s.frozen_bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
        outs.append(inplanes)
        planes *= 2
    return outs


def swin_specs(s: Specs, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
               window=12, mlp_ratio=4):
    dims = [embed_dim * 2 ** i for i in range(len(depths))]
    s.conv("backbone.patch_embed.projection", 3, embed_dim, 4)
    s.norm("backbone.patch_embed.norm", embed_dim)
    for st, depth in enumerate(depths):
        d = dims[st]
        for b in range(depth):
            p = f"backbone.stages.{st}.blocks.{b}"
            s.norm(f"{p}.norm1", d)
            s.linear(f"{p}.attn.w_msa.qkv", d, 3 * d)
            s.linear(f"{p}.attn.w_msa.proj", d, d)
            s.add(f"{p}.attn.w_msa.relative_position_bias_table",
                  ((2 * window - 1) ** 2, num_heads[st]), "relpos")
            s.norm(f"{p}.norm2", d)
            s.linear(f"{p}.ffn.layers.0.0", d, mlp_ratio * d)
            s.linear(f"{p}.ffn.layers.1", mlp_ratio * d, d)
        if st + 1 < len(depths):
            s.norm(f"backbone.stages.{st}.downsample.norm", 4 * d)
            s.linear(f"backbone.stages.{st}.downsample.reduction", 4 * d, dims[st + 1],
                     bias=False)
    for st, d in enumerate(dims):
        s.norm(f"backbone.norm{st}", d)
    return dims


def decoder_layer_specs(s: Specs, p, C, ffn):
    for a in range(2):
        s.add(f"{p}.attentions.{a}.attn.in_proj_weight", (3 * C, C), "fan_in")
        s.add(f"{p}.attentions.{a}.attn.in_proj_bias", (3 * C,), "zero")
        s.linear(f"{p}.attentions.{a}.attn.out_proj", C, C)
    for n in range(3):
        s.norm(f"{p}.norms.{n}", C)
    s.linear(f"{p}.ffns.0.layers.0.0", C, ffn)
    s.linear(f"{p}.ffns.0.layers.1", ffn, C)


def mlp_specs(s: Specs, p, cin, hidden, cout, layers=3):
    dims = [cin] + [hidden] * (layers - 1) + [cout]
    for i in range(layers):
        s.linear(f"{p}.{2 * i}", dims[i], dims[i + 1])


def head_specs(s: Specs, in_channels, h):
    C, L, H, P = h["embed_dims"], h["num_feat_levels"], h["num_heads"], 4
    Q, K = h["num_obj_query"], h["num_rel_query"]
    n_in = len(in_channels)
    pd = "bbox_head.pixel_decoder"
    for lvl in range(L):
        s.conv(f"{pd}.input_convs.{lvl}.conv", in_channels[n_in - 1 - lvl], C, 1)
        s.norm(f"{pd}.input_convs.{lvl}.gn", C)
    for i in range(h["pixel_decoder_layers"]):
        p = f"{pd}.encoder.layers.{i}"
        a = f"{p}.attentions.0"
        s.add(f"{a}.sampling_offsets.weight", (H * L * P * 2, C), "offset_noise")
        s.add(f"{a}.sampling_offsets.bias", (H * L * P * 2,), f"offset_grid:{H}:{L}:{P}")
        s.linear(f"{a}.attention_weights", C, H * L * P, kind="offset_noise")
        s.linear(f"{a}.value_proj", C, C)
        s.linear(f"{a}.output_proj", C, C)
        s.norm(f"{p}.norms.0", C)
        s.norm(f"{p}.norms.1", C)
        s.linear(f"{p}.ffns.0.layers.0.0", C, h["pixel_decoder_ffn"])
        s.linear(f"{p}.ffns.0.layers.1", h["pixel_decoder_ffn"], C)
    s.add(f"{pd}.level_encoding.weight", (L, C), "normal")
    for i in range(n_in - L):
        s.conv(f"{pd}.lateral_convs.{i}.conv", in_channels[i], C, 1)
        s.norm(f"{pd}.lateral_convs.{i}.gn", C)
        s.conv(f"{pd}.output_convs.{i}.conv", C, C, 3)
        s.norm(f"{pd}.output_convs.{i}.gn", C)
    s.conv(f"{pd}.mask_feature", C, C, 3)
    for i in range(h["num_decoder_layers"]):
        decoder_layer_specs(s, f"bbox_head.transformer_decoder.layers.{i}", C, h["decoder_ffn"])
    s.norm("bbox_head.transformer_decoder.post_norm", C)
    for name, rows in (("query_feat", Q), ("query_embed", Q), ("level_embed", L),
                       ("rel_query_feat", K), ("rel_query_embed", K),
                       ("rel_query_embed2", 2 * K), ("rel_query_embed3", 2 * K)):
        s.add(f"bbox_head.{name}.weight", (rows, C), "normal")
    s.linear("bbox_head.cls_embed", C, h["num_classes"] + 1)
    mlp_specs(s, "bbox_head.mask_embed", C, C, C)
    mlp_specs(s, "bbox_head.sub_query_update", C, C, C)
    mlp_specs(s, "bbox_head.obj_query_update", C, C, C)
    s.linear("bbox_head.rel_cls_embed", C, h["num_relations"])
    chans = (1, 64, 64, 1)
    for i in range(3):
        s.conv(f"bbox_head.update_importance.conv_layers.{i}.0", chans[i], chans[i + 1], 7)
    for i in range(h["num_relation_layers"]):
        decoder_layer_specs(s, f"bbox_head.relation_decoder.layers.{i}", C, h["relation_ffn"])


def param_specs(model_cfg: dict) -> Specs:
    """Every tensor of the model of ``model_cfg`` (the configuration file's
    ``model``): name, shape and initialiser kind."""
    s = Specs()
    bb = dict(model_cfg["backbone"])
    kind = bb.pop("type")
    if kind == "ResNet":
        outs = resnet_specs(s, **bb)
    elif kind == "SwinTransformer":
        outs = swin_specs(s, **{k: tuple(v) if isinstance(v, list) else v for k, v in bb.items()})
    else:
        raise ValueError(f"backbone {kind!r}: the reference has ResNet and SwinTransformer")
    head_specs(s, outs, model_cfg["head"])
    return s


# ---------------------------------------------------------------- ops


def linear(P, name, x, rnd, bias=True):
    b = P[f"{name}.bias"] if bias else None
    return F.linear(rnd(x), rnd(P[f"{name}.weight"]), b)


def conv(P, name, x, rnd, stride=1, padding=0, bias=True):
    b = P[f"{name}.bias"] if bias else None
    return F.conv2d(rnd(x), rnd(P[f"{name}.weight"]), b, stride=stride, padding=padding)


def layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def group_norm(P, name, x, groups=32):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def frozen_bn(P, name, x):
    scale = P[f"{name}.weight"] / torch.sqrt(P[f"{name}.running_var"] + BN_EPS)
    shift = P[f"{name}.bias"] - P[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def mlp(P, name, x, rnd, layers=3):
    for i in range(layers):
        x = linear(P, f"{name}.{2 * i}", x, rnd)
        if i + 1 < layers:
            x = F.relu(x)
    return x


def bilinear(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def sine_pos(h, w, C, device):
    """mmdet SinePositionalEncoding(normalize=True) of an unpadded (h, w)
    map: (h, w, C), y features first, sin at even and cos at odd indices."""
    n = C // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6) * 2 * math.pi
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6) * 2 * math.pi
    dim_t = 10000.0 ** (2 * (torch.arange(n, device=device) // 2).float() / n)
    py = y[:, None] / dim_t  # (h, n)
    px = x[:, None] / dim_t  # (w, n)
    py = torch.stack([py[:, 0::2].sin(), py[:, 1::2].cos()], -1).reshape(h, 1, n).expand(h, w, n)
    px = torch.stack([px[:, 0::2].sin(), px[:, 1::2].cos()], -1).reshape(1, w, n).expand(h, w, n)
    return torch.cat([py, px], -1)


def attention(P, name, q_in, k_in, v_in, heads, rnd, mask=None):
    """torch.nn.MultiheadAttention (packed in_proj, batch first); ``mask``
    (B, Lq, Lk) bool, True = masked out."""
    C = q_in.shape[-1]
    W, b = P[f"{name}.in_proj_weight"], P[f"{name}.in_proj_bias"]
    q = F.linear(rnd(q_in), rnd(W[:C]), b[:C])
    k = F.linear(rnd(k_in), rnd(W[C:2 * C]), b[C:2 * C])
    v = F.linear(rnd(v_in), rnd(W[2 * C:]), b[2 * C:])
    B, Lq, Lk, D = q.shape[0], q.shape[1], k.shape[1], C // heads
    q = q.reshape(B, Lq, heads, D).transpose(1, 2)
    k = k.reshape(B, Lk, heads, D).transpose(1, 2)
    v = v.reshape(B, Lk, heads, D).transpose(1, 2)
    logits = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(D)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None], float("-inf"))
    out = rnd(torch.softmax(logits, -1)) @ rnd(v)
    return linear(P, f"{name}.out_proj", out.transpose(1, 2).reshape(B, Lq, C), rnd)


def decoder_layer(P, name, query, query_pos, memory, memory_pos, heads, rnd, mask=None,
                  dropout=None):
    """cross-attention -> norm -> self-attention -> norm -> FFN -> norm;
    ``memory_pos`` is added to the keys only. ``dropout(x)`` is applied
    after the FFN's ReLU and after its second linear (train mode)."""
    drop = dropout or identity
    k = memory if memory_pos is None else memory + memory_pos
    x = query + attention(P, f"{name}.attentions.0.attn", query + query_pos, k, memory, heads,
                          rnd, mask)
    x = layer_norm(P, f"{name}.norms.0", x)
    x = x + attention(P, f"{name}.attentions.1.attn", x + query_pos, x + query_pos, x, heads,
                      rnd)
    x = layer_norm(P, f"{name}.norms.1", x)
    y = drop(F.relu(linear(P, f"{name}.ffns.0.layers.0.0", x, rnd)))
    x = x + drop(linear(P, f"{name}.ffns.0.layers.1", y, rnd))
    return layer_norm(P, f"{name}.norms.2", x)


# ---------------------------------------------------------------- backbones


def resnet(P, x, rnd, depth=50, base_width=64):
    x = F.relu(frozen_bn(P, "backbone.bn1", conv(P, "backbone.conv1", x, rnd, 2, 3, False)))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for stage, n in enumerate(RESNET_BLOCKS[depth]):
        for b in range(n):
            p = f"backbone.layer{stage + 1}.{b}"
            stride = 2 if (b == 0 and stage > 0) else 1
            y = F.relu(frozen_bn(P, f"{p}.bn1", conv(P, f"{p}.conv1", x, rnd, bias=False)))
            y = F.relu(frozen_bn(P, f"{p}.bn2",
                                 conv(P, f"{p}.conv2", y, rnd, stride, 1, bias=False)))
            y = frozen_bn(P, f"{p}.bn3", conv(P, f"{p}.conv3", y, rnd, bias=False))
            if b == 0:
                x = frozen_bn(P, f"{p}.downsample.1",
                              conv(P, f"{p}.downsample.0", x, rnd, stride, bias=False))
            x = F.relu(y + x)
        outs.append(x)
    return outs


def _shift_mask(Hp, Wp, w, shift, device):
    """(nW, w*w, w*w) additive mask of the shifted windows: -100 between
    tokens of different regions of the padded map."""
    region = torch.zeros(Hp, Wp, device=device)
    cuts = lambda n: (0, n - w, n - shift, n)  # noqa: E731
    hs, ws = cuts(Hp), cuts(Wp)
    r = 0
    for i in range(3):
        for j in range(3):
            region[hs[i]:hs[i + 1], ws[j]:ws[j + 1]] = r
            r += 1
    win = region.reshape(Hp // w, w, Wp // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    return (win[:, :, None] != win[:, None, :]).float() * -100.0


def _rel_index(w, device):
    c = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]) + (w - 1)
    return (rel[0] * (2 * w - 1) + rel[1]).flatten().to(device)


def swin_block(P, p, x, heads, w, shift, rnd):
    B, H, W, C = x.shape
    y = layer_norm(P, f"{p}.norm1", x)
    Hp, Wp = -(-H // w) * w, -(-W // w) * w
    y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = y.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)
    N, D = w * w, C // heads
    qkv = linear(P, f"{p}.attn.w_msa.qkv", win, rnd).reshape(-1, N, 3, heads, D)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = rnd(q * D ** -0.5) @ rnd(k).transpose(-1, -2)
    table = P[f"{p}.attn.w_msa.relative_position_bias_table"]
    attn = attn + table[_rel_index(w, x.device)].reshape(N, N, heads).permute(2, 0, 1)
    if shift:
        nW = (Hp // w) * (Wp // w)
        attn = (attn.reshape(B, nW, heads, N, N)
                + _shift_mask(Hp, Wp, w, shift, x.device)[None, :, None]).reshape(-1, heads, N, N)
    out = (rnd(torch.softmax(attn, -1)) @ rnd(v)).transpose(1, 2).reshape(-1, N, C)
    out = linear(P, f"{p}.attn.w_msa.proj", out, rnd)
    y = out.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y[:, :H, :W]
    y = F.gelu(linear(P, f"{p}.ffn.layers.0.0", layer_norm(P, f"{p}.norm2", x), rnd))
    return x + linear(P, f"{p}.ffn.layers.1", y, rnd)


def swin(P, x, rnd, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=12,
         mlp_ratio=4):
    H, W = x.shape[2:]
    ph, pw = -H % 4, -W % 4
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    x = conv(P, "backbone.patch_embed.projection", x, rnd, stride=4).permute(0, 2, 3, 1)
    x = layer_norm(P, "backbone.patch_embed.norm", x)
    outs = []
    for st, depth in enumerate(depths):
        for b in range(depth):
            shift = window // 2 if b % 2 else 0
            x = swin_block(P, f"backbone.stages.{st}.blocks.{b}", x, num_heads[st], window,
                           shift, rnd)
        outs.append(layer_norm(P, f"backbone.norm{st}", x).permute(0, 3, 1, 2))
        if st + 1 < len(depths):
            B, h, w, C = x.shape
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
            # 2x2 neighbourhoods in mmdet's nn.Unfold order (c, ky, kx)
            x = x.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
            x = x.reshape(B, h // 2, w // 2, 4 * C)
            x = linear(P, f"backbone.stages.{st}.downsample.reduction",
                       layer_norm(P, f"backbone.stages.{st}.downsample.norm", x), rnd,
                       bias=False)
    return outs


# ---------------------------------------------------------------- head


def msda(value, shapes, locs, weights):
    """value (B, S, H, D); locs (B, Q, H, L, P, 2) in [0, 1] as (x, y);
    weights (B, Q, H, L, P) -> (B, Q, H * D), bilinear with zero padding."""
    B, S, H, D = value.shape
    Q, L, Pn = locs.shape[1], locs.shape[3], locs.shape[4]
    out = 0
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * H, D, h, w)
        start += h * w
        grid = 2 * locs[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * H, Q, Pn, 2) - 1
        taps = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)  # (B*H, D, Q, P)
        wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, 1, Q, Pn)
        out = out + (taps * wl).sum(-1)  # (B*H, D, Q)
    return out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)


def pixel_decoder(P, feats, h, rnd):
    """feats: backbone maps high -> low resolution. Returns (mask features,
    the encoder's maps low -> high resolution)."""
    pd = "bbox_head.pixel_decoder"
    C, L, H, Pn = h["embed_dims"], h["num_feat_levels"], h["num_heads"], 4
    n_in = len(feats)
    B = feats[0].shape[0]
    toks, pos, shapes = [], [], []
    for lvl in range(L):
        x = group_norm(P, f"{pd}.input_convs.{lvl}.gn",
                       conv(P, f"{pd}.input_convs.{lvl}.conv", feats[n_in - 1 - lvl], rnd))
        hh, ww = x.shape[-2:]
        toks.append(x.flatten(2).transpose(1, 2))
        pos.append(sine_pos(hh, ww, C, x.device).reshape(1, hh * ww, C)
                   + P[f"{pd}.level_encoding.weight"][lvl])
        shapes.append((hh, ww))
    x, pos = torch.cat(toks, 1), torch.cat(pos, 1)
    refs = []
    for hh, ww in shapes:
        ys = (torch.arange(hh, device=x.device) + 0.5) / hh
        xs = (torch.arange(ww, device=x.device) + 0.5) / ww
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([xx, yy], -1).reshape(-1, 2))
    ref = torch.cat(refs)[None, :, None, None, None, :]  # (1, S, 1, 1, 1, 2)
    norm = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32, device=x.device)
    S = x.shape[1]
    for i in range(h["pixel_decoder_layers"]):
        p = f"{pd}.encoder.layers.{i}"
        a = f"{p}.attentions.0"
        q = x + pos
        v = linear(P, f"{a}.value_proj", x, rnd).reshape(B, S, H, C // H)
        off = linear(P, f"{a}.sampling_offsets", q, rnd).reshape(B, S, H, L, Pn, 2)
        wts = linear(P, f"{a}.attention_weights", q, rnd).reshape(B, S, H, L * Pn)
        wts = torch.softmax(wts, -1).reshape(B, S, H, L, Pn)
        locs = ref + off / norm[None, None, None, :, None, :]
        x = x + linear(P, f"{a}.output_proj", msda(v, shapes, locs, wts), rnd)
        x = layer_norm(P, f"{p}.norms.0", x)
        y = F.relu(linear(P, f"{p}.ffns.0.layers.0.0", x, rnd))
        x = layer_norm(P, f"{p}.norms.1", x + linear(P, f"{p}.ffns.0.layers.1", y, rnd))
    outs, start = [], 0
    for hh, ww in shapes:
        outs.append(x[:, start:start + hh * ww].transpose(1, 2).reshape(B, C, hh, ww))
        start += hh * ww
    y = outs[-1]
    for i in range(n_in - 1 - L, -1, -1):
        lat = group_norm(P, f"{pd}.lateral_convs.{i}.gn",
                         conv(P, f"{pd}.lateral_convs.{i}.conv", feats[i], rnd))
        y = lat + bilinear(y, lat.shape[-2:])
        y = F.relu(group_norm(P, f"{pd}.output_convs.{i}.gn",
                              conv(P, f"{pd}.output_convs.{i}.conv", y, rnd, padding=1)))
    return conv(P, f"{pd}.mask_feature", y, rnd, padding=1), outs


def mask2former_decoder(P, mf, ms, h, rnd, masks=None, record=None):
    """Queries after the masked-attention decoder, and (cls, mask) logits.
    Layer i attends with ``masks[i]`` (B, Q, S) when given, else with its
    own mask; ``record`` receives (the mask used, this module's own mask
    logits) of each layer."""
    C, heads = h["embed_dims"], h["num_heads"]
    B = mf.shape[0]
    td = "bbox_head.transformer_decoder"
    mems, mem_pos, shapes = [], [], []
    for lvl, f in enumerate(ms):
        hh, ww = f.shape[-2:]
        mems.append(f.flatten(2).transpose(1, 2) + P["bbox_head.level_embed.weight"][lvl])
        mem_pos.append(sine_pos(hh, ww, C, f.device).reshape(1, hh * ww, C))
        shapes.append((hh, ww))
    small = [bilinear(mf, hw).flatten(2).transpose(1, 2) for hw in shapes]

    def mask_embed(q):
        return mlp(P, "bbox_head.mask_embed", layer_norm(P, f"{td}.post_norm", q), rnd)

    query = P["bbox_head.query_feat.weight"][None].expand(B, -1, -1)
    qpos = P["bbox_head.query_embed.weight"][None]
    n = len(shapes)
    for i in range(h["num_decoder_layers"]):
        logits = torch.einsum("bqc,bsc->bqs", rnd(mask_embed(query)), rnd(small[i % n]))
        mask = torch.sigmoid(logits) < 0.5
        mask = mask & ~mask.all(-1, keepdim=True)  # a row masked everywhere attends everywhere
        if masks is not None:
            mask = masks[i]
        if record is not None:
            record.append((mask, logits))
        query = decoder_layer(P, f"{td}.layers.{i}", query, qpos, mems[i % n], mem_pos[i % n],
                              heads, rnd, mask)
    cls = linear(P, "bbox_head.cls_embed", layer_norm(P, f"{td}.post_norm", query), rnd)
    return query, cls, mask_head(P, query, mf, rnd)


def mask_head(P, query, mf, rnd=identity):
    """The mask logits (B, Q, H/4, W/4) of the decoder's final queries over
    the mask features."""
    out = layer_norm(P, "bbox_head.transformer_decoder.post_norm", query)
    return torch.einsum("bqc,bchw->bqhw", rnd(mlp(P, "bbox_head.mask_embed", out, rnd)), rnd(mf))


def pair_importance(P, query, rnd=identity):
    """The Pair Proposal Network's (B, Q, Q) importance of the decoder's
    queries: cosine affinity of the subject and object embeddings, refined
    by the ConvTiny matrix learner (three 7x7 convolutions, ReLU between)."""
    sub = mlp(P, "bbox_head.sub_query_update", query, rnd)
    obj = mlp(P, "bbox_head.obj_query_update", query, rnd)
    sub = sub / sub.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    obj = obj / obj.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    y = (rnd(sub) @ rnd(obj).transpose(1, 2))[:, None]
    for i in range(3):
        y = conv(P, f"bbox_head.update_importance.conv_layers.{i}.0", y, rnd, padding=3)
        if i < 2:
            y = F.relu(y)
    return y[:, 0]


def backbone(P, images, model_cfg, rnd):
    """images (B, H, W, 3) -> the backbone's four maps."""
    bb = dict(model_cfg["backbone"])
    kind = bb.pop("type")
    x = images.permute(0, 3, 1, 2).float()
    if kind == "ResNet":
        return resnet(P, x, rnd, **bb)
    return swin(P, x, rnd, **{k: tuple(v) if isinstance(v, list) else v for k, v in bb.items()})


def forward(P, images, model_cfg, rnd=identity, pairs=None, masks=None, record=None,
            dropout=None):
    """The head outputs of ``images`` (B, H, W, 3). ``pairs`` (sub_pos,
    obj_pos), each (B, K), replaces the top-k pair choice and ``masks`` the
    decoder's attention masks (the check replays the system's decisions and
    holds them against this module's own by themselves; ``record`` receives
    each decoder layer's mask and own logits). ``dropout`` is the Relation
    Fusion FFN's (train mode)."""
    h = model_cfg["head"]
    feats = backbone(P, images, model_cfg, rnd)
    mf, ms = pixel_decoder(P, feats, h, rnd)
    query, cls, mask = mask2former_decoder(P, mf, ms[:h["num_feat_levels"]], h, rnd, masks,
                                           record)
    B, Q, _ = query.shape
    K = h["num_rel_query"]
    importance = pair_importance(P, query, rnd)
    if pairs is None:
        idx = importance.reshape(B, Q * Q).topk(K, dim=-1).indices
        pairs = (idx // Q, idx % Q)
    sub_pos, obj_pos = pairs
    rows = torch.arange(B, device=query.device)[:, None]
    pair_feat = torch.cat([query[rows, sub_pos], query[rows, obj_pos]], 1)
    rel_q = P["bbox_head.rel_query_feat.weight"][None].expand(B, -1, -1)
    rel_pos = P["bbox_head.rel_query_embed.weight"][None]
    key_pos = P["bbox_head.rel_query_embed2.weight"][None]
    for i in range(h["num_relation_layers"]):
        rel_q = decoder_layer(P, f"bbox_head.relation_decoder.layers.{i}", rel_q, rel_pos,
                              pair_feat, key_pos, h["num_heads"], rnd, dropout=dropout)
    return {
        "cls": cls, "mask": mask, "rel": linear(P, "bbox_head.rel_cls_embed", rel_q, rnd),
        "queries": query, "mask_features": mf,
        "importance": importance, "sub": cls[rows, sub_pos], "obj": cls[rows, obj_pos],
        "sub_seg": mask[rows, sub_pos], "obj_seg": mask[rows, obj_pos],
        "sub_pos": sub_pos, "obj_pos": obj_pos,
    }
