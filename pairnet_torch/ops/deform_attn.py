"""Multi-scale deformable attention (MSDA) core op and its dispatcher.

Counterpart of ``pairnet_tpu/ops/deform_attn.py``. Semantics follow mmcv's
CUDA kernel: a sampling location p in [0, 1] maps to the pixel coordinate
``p * size - 0.5`` of its level, and bilinear corners outside the level's
plane count zero.

Shapes (the JAX package's layout):
  value:               (B, S, H, D)   S = sum_l h_l * w_l, row-major levels
  spatial_shapes:      ((h1, w1), ...)
  sampling_locations:  (B, Q, H, L, P, 2)  normalized (x, y)
  attention_weights:   (B, Q, H, L, P)
Returns                (B, Q, H * D)

Implementations (``impl``):
  "exact"    -- CUDA kernel, f32 or bf16 values, f32 output (default on CUDA)
  "int4"     -- CUDA int4 quantize + gather, bf16 output (bf16 serving, v16)
  "int8"     -- CUDA int8 quantize + gather, bf16 output (v12 / v14)
  "plain"    -- :func:`ms_deform_attn_plain`, plain PyTorch, f32 output
Every impl computes the same function on CPU tensors as on CUDA ones: the
kernels' wrappers take their plain versions on the CPU (the quantized impls
quantize there too). "exact", "int4" and "int8" are autograd Functions
whose backward is the MSDA backward variant ``bwd`` ("exact" or
"bf16_grad", ``ops/deform_attn_bwd.py``) on the full-precision inputs: the
kernel on CUDA, its plain version on CPU. "plain" differentiates through
:func:`ms_deform_attn_plain` itself.
"""

from __future__ import annotations

from typing import Sequence

import torch

IMPLS = ("exact", "int4", "int8", "plain")


def level_starts(spatial_shapes: Sequence[tuple[int, int]]) -> list[int]:
    offs = [0]
    for h, w in spatial_shapes:
        offs.append(offs[-1] + h * w)
    return offs


def _sample_level(value_l, loc, h, w):
    """Bilinear taps of one level, row-gather formulation.

    value_l (B, H, h*w, D) f32; loc (B, Q, H, P, 2). Returns (B, H, Q, P, D).
    """
    B, Hn, _, D = value_l.shape
    Q, P = loc.shape[1], loc.shape[3]
    loc = loc.permute(0, 2, 1, 3, 4)  # (B, H, Q, P, 2)
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def corner(xi, yi, wgt):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        idx = (yi_c * w + xi_c).reshape(B, Hn, Q * P, 1).expand(-1, -1, -1, D)
        g = torch.gather(value_l, 2, idx).reshape(B, Hn, Q, P, D)
        return g * (wgt * inside)[..., None]

    return (
        corner(x0, y0, (1 - fx) * (1 - fy))
        + corner(x0 + 1, y0, fx * (1 - fy))
        + corner(x0, y0 + 1, (1 - fx) * fy)
        + corner(x0 + 1, y0 + 1, fx * fy)
    )


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """Plain PyTorch MSDA with the row-gather semantics of the JAX
    ``_ms_deform_attn_single``. Values are read in f32, the sum is f32."""
    B, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    offs = level_starts(spatial_shapes)
    value = value.float()
    locs = sampling_locations.float()
    weights = attention_weights.float()
    acc = None
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = value[:, offs[lvl] : offs[lvl + 1]].permute(0, 2, 1, 3)  # (B,H,hw,D)
        sampled = _sample_level(v_l, locs[:, :, :, lvl], h, w)  # (B,H,Q,P,D)
        term = torch.einsum("bhqpd,bqhp->bqhd", sampled, weights[:, :, :, lvl])
        acc = term if acc is None else acc + term
    return acc.reshape(B, Q, H * D)


def bf16_ulps_off(out, ref, floor=2.0 ** -10):
    """Number of entries of ``out`` more than one bf16 ulp (8 significant
    bits) from ``ref``: the tolerance of a kernel's bf16 output against its
    plain version. The ulp is taken at the larger magnitude of the two,
    floored at ``floor``, because near 0 the two f32 sums differ by
    reassociation alone (~1e-7 of the summed terms)."""
    out, ref = out.float(), ref.float()
    mag = torch.maximum(out.abs(), ref.abs()).clamp_min(floor)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
    return int(((out - ref).abs() > ulp).sum())


def check_inputs(value, spatial_shapes, locs, weights):
    """Raise unless the four arguments have the MSDA layout."""
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    if S != level_starts(spatial_shapes)[-1]:
        raise ValueError(f"value has S={S} tokens, levels {spatial_shapes} need "
                         f"{level_starts(spatial_shapes)[-1]}")
    if locs.dim() != 6 or locs.shape[:4] != (B, locs.shape[1], H, L) or locs.shape[5] != 2:
        raise ValueError(f"sampling locations {tuple(locs.shape)} are not (B, Q, H, L, P, 2)")
    if weights.shape != locs.shape[:5]:
        raise ValueError(f"attention weights {tuple(weights.shape)} are not "
                         f"{tuple(locs.shape[:5])}")
    if not (locs.device == weights.device == value.device):
        raise ValueError("value, locations and weights must be on one device")


def check_width(D, what):
    """Raise unless the warp-per-query kernels take the head width ``D``: a
    multiple of 8 up to 64 (a lane owns 8 channels of a head)."""
    if D % 8 or not 8 <= D <= 64:
        raise ValueError(f"{what}: the kernel takes D a multiple of 8 up to 64, not {D}")


def aligned(*tensors):
    """Each tensor contiguous and at a 16-byte aligned address, as the
    kernels' vector loads and stores need."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return tuple(out)


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights,
                   impl: str | None = None, bwd: str = "exact"):
    """Batched MSDA (see module doc). ``impl=None`` means "exact" on CUDA."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown ms_deform_attn impl {impl!r}: expected one of {IMPLS}")
    if impl == "plain":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if impl == "int4":
        from pairnet_torch.ops.deform_attn_int4 import ms_deform_attn_int4

        return ms_deform_attn_int4(
            value, spatial_shapes, sampling_locations, attention_weights, bwd
        )
    if impl == "int8":
        from pairnet_torch.ops.deform_attn_int8 import ms_deform_attn_int8

        return ms_deform_attn_int8(
            value, spatial_shapes, sampling_locations, attention_weights, bwd
        )
    from pairnet_torch.ops.deform_attn_exact import ms_deform_attn_exact

    return ms_deform_attn_exact(
        value, spatial_shapes, sampling_locations, attention_weights, bwd
    )
