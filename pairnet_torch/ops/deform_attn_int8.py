"""int8 MSDA: wrappers of the int8 instances of ``csrc/deform_attn_quant.cu``.

Replaces the int8 TPU kernels:

* ``pallas_deform_attn_v12.py::_qp_kernel`` (quantize and pack, bf16 or
  f32 values) becomes :func:`int8_quantize`: one scale per
  (b, h, level, d), ``max(absmax / 127, 1e-20)`` (``v12.py:310-314``);
  codes ``clip(round_half_even(v / scale), -127, 127)`` with an f32 divide
  (``v12.py:73``). Codes are int8 in the value layout (B, S, H, D); scales
  f32 (B, H, L, D).
* ``pallas_deform_attn_v12.py::_kernel`` and its bit-identical twin
  ``pallas_deform_attn_v14.py::_kernel`` (levels fused, bf16 out) become
  :func:`int8_gather` with ``out_dtype=torch.bfloat16``;
  ``pallas_deform_attn_v10.py::_kernel`` and ``v11.py::_kernel`` (the
  parity anchors, f32 out, the scale folded outside) become the
  ``out_dtype=torch.float32`` instance.

The gather follows the TPU kernels' arithmetic: each in-plane corner adds
``code * ((corner weight) * a)`` with the attention weight ``a`` folded into
the corner weight first (``v10.py:76-79``), taps sum in f32, each level's
tap sum is scaled by its (level, d) scale, and the levels add in f32.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. :func:`ms_deform_attn_int8` is differentiable
like the ``custom_vjp`` of ``ms_deform_attn_pallas_v12``: the MSDA backward
on the saved full-precision inputs (``v12.py:370-376``).
"""

from __future__ import annotations

import collections

import torch

from pairnet_torch.ops.deform_attn import level_starts
from pairnet_torch.ops.deform_attn_bwd import MSDAFunction
from pairnet_torch.ops.deform_attn_int4 import launch_gather, launch_quantize, quantize_plain

# kernel instance suffix per dtype: the value dtype of the quantize, the
# output dtype of the gather
INSTANCES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def int8_quantize_plain(value, spatial_shapes):
    """Plain version of :func:`int8_quantize`: (codes int8, scales f32)."""
    return quantize_plain(value, spatial_shapes, 127)


def _level_taps(codes_l, loc, aw, h, w):
    """One level's tap sums on the codes: codes_l (B, H, h*w, D) f32; loc
    (B, Q, H, P, 2); aw (B, Q, H, P). Returns (B, H, Q, D)."""
    B, Hn, _, D = codes_l.shape
    Q, P = loc.shape[1], loc.shape[3]
    loc = loc.permute(0, 2, 1, 3, 4)  # (B, H, Q, P, 2)
    aw = aw.permute(0, 2, 1, 3)  # (B, H, Q, P)
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def corner(xi, yi, wgt):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        g = torch.gather(codes_l, 2, idx.reshape(B, Hn, Q * P, 1).expand(-1, -1, -1, D))
        return g.reshape(B, Hn, Q, P, D) * (wgt * aw * inside)[..., None]

    taps = (corner(x0, y0, (1 - fx) * (1 - fy)) + corner(x0 + 1, y0, fx * (1 - fy))
            + corner(x0, y0 + 1, (1 - fx) * fy) + corner(x0 + 1, y0 + 1, fx * fy))
    return taps.sum(dim=3)


def int8_gather_plain(codes, scales, spatial_shapes, sampling_locations, attention_weights,
                      out_dtype=torch.bfloat16):
    """Plain version of :func:`int8_gather`, in the TPU kernels' order:
    per level the tap sum on the codes, times the level's scale; the levels
    summed in f32; cast to ``out_dtype``."""
    B, S, H, D = codes.shape
    Q = sampling_locations.shape[1]
    offs = level_starts(spatial_shapes)
    locs = sampling_locations.float()
    weights = attention_weights.float()
    out = None
    for lvl, (h, w) in enumerate(spatial_shapes):
        cl = codes[:, offs[lvl] : offs[lvl + 1]].float().permute(0, 2, 1, 3)  # (B,H,hw,D)
        res = _level_taps(cl, locs[:, :, :, lvl], weights[:, :, :, lvl], h, w)
        res = res * scales[:, :, lvl, None, :]  # (B, H, Q, D) x (B, H, 1, D)
        out = res if out is None else out + res
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(out_dtype)


def int8_quantize(value, spatial_shapes):
    """Per-(b, h, level, d) int8 quantization of the value plane; bf16 or
    f32 values."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return int8_quantize_plain(value, spatial_shapes)
    if value.dtype not in INSTANCES:
        raise TypeError(f"int8_quantize: value dtype {value.dtype} is not bf16 or f32")
    inst = INSTANCES[value.dtype]
    out = launch_quantize(f"int8_quantize_{inst}", "int8_quantize", value, spatial_shapes)
    int8_quantize.launches[inst] += 1
    return out


def int8_gather(codes, scales, spatial_shapes, sampling_locations, attention_weights,
                out_dtype=torch.bfloat16):
    """MSDA on int8 codes with the scales folded in per level; an
    ``out_dtype`` (bf16 or f32) tensor (B, Q, H * D)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if out_dtype not in INSTANCES:
        raise TypeError(f"int8_gather: out_dtype {out_dtype} is not bf16 or f32")
    if codes.device.type == "cpu":
        return int8_gather_plain(codes, scales, spatial_shapes, sampling_locations,
                                 attention_weights, out_dtype)
    inst = INSTANCES[out_dtype]
    out = launch_gather(f"int8_gather_{inst}", "int8_gather", out_dtype, codes, scales,
                        spatial_shapes, sampling_locations, attention_weights)
    int8_gather.launches[inst] += 1
    return out


# launches per kernel instance ("bf16", "f32")
int8_quantize.launches = collections.Counter()
int8_gather.launches = collections.Counter()


def _int8_forward(value, spatial_shapes, locs, weights):
    codes, scales = int8_quantize(value, spatial_shapes)
    return int8_gather(codes, scales, spatial_shapes, locs, weights)


def ms_deform_attn_int8(value, spatial_shapes, sampling_locations, attention_weights,
                        bwd: str = "exact"):
    """int8 MSDA (the v12 / v14 serving kernels): quantize, then gather,
    bf16 (B, Q, H * D). Differentiable through the ``bwd`` variant of the
    MSDA backward."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDAFunction.apply(_int8_forward, value, sampling_locations, attention_weights,
                              spatial_shapes, bwd)
