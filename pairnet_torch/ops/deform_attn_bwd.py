"""MSDA backward: the wrapper of ``csrc/deform_attn_bwd.cu`` and its plain version.

Replaces ``pairnet_tpu/ops/pallas_deform_bwd2.py::_bwd2_kernel`` (the
default VJP), ``pairnet_tpu/ops/pallas_deform_attn_v6.py::_bwd_kernel`` (the
same gradients) and ``pairnet_tpu/ops/pallas_deform_bwd3.py::_bwd3_kernel``
(bf16-rounded upstream grad). Variants (``bwd``):

* ``"exact"``: f32 arithmetic on the values as given (f32 or bf16);
* ``"bf16_grad"``: bwd3's roundings: values and upstream grad rounded to
  bf16 for every use, and each per-tap product ``bf16(g * cw * a)`` rounded
  before the f32 sum into dvalue.

Returns ``(dvalue, dlocs, dweights)`` in the dtypes of value, locations and
weights. On CPU tensors :func:`deform_attn_bwd` runs the plain version; on
CUDA tensors it launches the kernel (one warp per query; D a multiple of 8
up to 64, the upstream grad read as f32 or bf16) or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from pairnet_torch.ops import _build
from pairnet_torch.ops.deform_attn import (
    aligned,
    bf16_ulps_off,
    check_inputs,
    check_width,
    level_starts,
    ms_deform_attn_plain,
)

BWD_VARIANTS = ("exact", "bf16_grad")
BWD_TOLERANCE = 1e-4  # f32 outputs: max |kernel - plain| <= BWD_TOLERANCE * max |plain|
# kernel instance -> C launcher
_FN = {"f32": "deform_attn_bwd_f32", "bf16": "deform_attn_bwd_bf16",
       "bf16_grad": "deform_attn_bwd_bf16_grad"}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("deform_attn_bwd")
    for name in _FN.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 4 + [_I] + [_P] * 4 + [_I] * 7 + [_P, _P]
        fn.restype = ctypes.c_int
    return lib


def instance(value_dtype, bwd: str) -> str:
    """The kernel instance that runs variant ``bwd`` on values of this dtype."""
    if bwd == "bf16_grad":
        if value_dtype != torch.bfloat16:
            raise TypeError(f"the bf16_grad backward takes bf16 values, not {value_dtype}")
        return "bf16_grad"
    if value_dtype == torch.float32:
        return "f32"
    if value_dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"MSDA backward: value dtype {value_dtype} is not f32 or bf16")


def _dvalue_bf16_grad(value, spatial_shapes, locs, weights, g):
    """dvalue with bwd3's roundings: sum over taps of bf16(g * (cw * a) * ok).
    All arguments f32 (g already bf16-rounded); returns (B, S, H, D) f32."""
    B, S, H, D = value.shape
    Q, P = locs.shape[1], locs.shape[4]
    offs = level_starts(spatial_shapes)
    dv = value.new_zeros((B, H, S, D))
    gq = g.reshape(B, Q, H, 1, D)
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = locs[:, :, :, lvl, :, 0] * w - 0.5  # (B, Q, H, P)
        y = locs[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        aw = weights[:, :, :, lvl]
        for dx, dy, cw in ((0, 0, (1 - fy) * (1 - fx)), (1, 0, (1 - fy) * fx),
                           (0, 1, fy * (1 - fx)), (1, 1, fy * fx)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            prod = (gq * ((cw * aw) * ok)[..., None]).to(torch.bfloat16).float()
            idx = offs[lvl] + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            idx = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
            dv.scatter_add_(2, idx, prod.permute(0, 2, 1, 3, 4).reshape(B, H, Q * P, D))
    return dv.permute(0, 2, 1, 3)


def ms_deform_attn_bwd_plain(value, spatial_shapes, locs, weights, g, bf16_grad=False):
    """Plain version: ``torch.autograd.grad`` through
    :func:`ms_deform_attn_plain`; with ``bf16_grad`` the roundings of the
    bf16_grad variant applied explicitly."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, S, H, D = value.shape
    Q = locs.shape[1]
    v = value.detach().float()
    gg = g.detach().float().reshape(B, Q, H * D)
    if bf16_grad:
        v = v.to(torch.bfloat16).float()
        gg = gg.to(torch.bfloat16).float()
    lc = locs.detach().float().requires_grad_()
    wt = weights.detach().float().requires_grad_()
    v.requires_grad_(not bf16_grad)
    with torch.enable_grad():
        out = ms_deform_attn_plain(v, spatial_shapes, lc, wt)
        inputs = (lc, wt) if bf16_grad else (v, lc, wt)
        grads = torch.autograd.grad(out, inputs, gg)
    if bf16_grad:
        dvalue = _dvalue_bf16_grad(v, spatial_shapes, lc.detach(), wt.detach(), gg)
        dlocs, dweights = grads
    else:
        dvalue, dlocs, dweights = grads
    return dvalue.to(value.dtype), dlocs.to(locs.dtype), dweights.to(weights.dtype)


def deform_attn_bwd(value, spatial_shapes, locs, weights, g, bwd: str = "exact"):
    """MSDA backward ``(dvalue, dlocs, dweights)`` for the upstream grad ``g``
    (B, Q, H * D) of the forward output."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if bwd not in BWD_VARIANTS:
        raise ValueError(f"unknown MSDA backward {bwd!r}: expected one of {BWD_VARIANTS}")
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_plain(value, spatial_shapes, locs, weights, g,
                                        bf16_grad=bwd == "bf16_grad")
    if value.device.type != "cuda":
        raise ValueError(f"deform_attn_bwd: unsupported device {value.device}")
    inst = instance(value.dtype, bwd)
    check_inputs(value, spatial_shapes, locs, weights)
    B, S, H, D = value.shape
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    if g.shape != (B, Q, H * D) or g.device != value.device:
        raise ValueError(f"deform_attn_bwd: upstream grad {tuple(g.shape)} is not {(B, Q, H * D)}")
    check_width(D, "deform_attn_bwd")
    # the kernel reads g in its own dtype, f32 or bf16
    gg = g if g.dtype in (torch.float32, torch.bfloat16) else g.float()
    value, lc, wt, gg = aligned(value, locs.float(), weights.float(), gg)
    scratch = torch.empty((B, S, H, D), device=value.device, dtype=torch.float32)
    dvalue = scratch if value.dtype == torch.float32 else torch.empty_like(value)
    dlocs = torch.empty_like(lc)
    dweights = torch.empty_like(wt)
    hw = _build.host_shapes(spatial_shapes)
    with torch.cuda.device(value.device):
        status = getattr(_lib(), _FN[inst])(
            value.data_ptr(), lc.data_ptr(), wt.data_ptr(), gg.data_ptr(),
            int(gg.dtype == torch.bfloat16), scratch.data_ptr(), dvalue.data_ptr(),
            dlocs.data_ptr(), dweights.data_ptr(), B, S, Q, H, D, L, P,
            ctypes.addressof(hw), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, f"deform_attn_bwd ({inst})")
    deform_attn_bwd.launches[inst] += 1
    return dvalue, dlocs.to(locs.dtype), dweights.to(weights.dtype)


# launches per kernel instance ("f32", "bf16", "bf16_grad")
deform_attn_bwd.launches = collections.Counter()


class MSDAFunction(torch.autograd.Function):
    """An MSDA forward ``fwd(value, spatial_shapes, locs, weights)`` made
    differentiable, the counterpart of the forward kernels' ``custom_vjp``:
    it saves the full-precision (value, locs, weights), whatever ``fwd``
    computes from them, and its backward is :func:`deform_attn_bwd`."""

    @staticmethod
    def forward(ctx, fwd, value, locs, weights, spatial_shapes, bwd):
        ctx.save_for_backward(value, locs, weights)
        ctx.spatial_shapes, ctx.bwd = spatial_shapes, bwd
        return fwd(value, spatial_shapes, locs, weights)

    @staticmethod
    def backward(ctx, g):
        value, locs, weights = ctx.saved_tensors
        grads = deform_attn_bwd(value, ctx.spatial_shapes, locs, weights, g, ctx.bwd)
        return (None, *grads, None, None)


def bwd_mismatch(out, ref):
    """Hold a kernel's ``(dvalue, dlocs, dweights)`` against the plain
    version's. An f32 output must lie within ``BWD_TOLERANCE * max|plain|``;
    a bf16 one (dvalue of bf16 values, dweights of bf16 weights) within one
    bf16 ulp, since the two f32 sums differ in order before the one
    rounding; the ulp is floored at 2^-10 of max|plain|.
    Returns (largest |kernel - plain| over the three, list of failures)."""
    err, failures = 0.0, []
    for name, k, p in zip(("dvalue", "dlocs", "dweights"), out, ref):
        d = float((k.float() - p.float()).abs().max())
        scale = float(p.float().abs().max())
        err = max(err, d)
        if k.dtype != p.dtype or k.shape != p.shape:
            failures.append(f"{name}: {k.dtype} {tuple(k.shape)} vs plain {p.dtype} "
                            f"{tuple(p.shape)}")
        elif k.dtype == torch.bfloat16:
            n = bf16_ulps_off(k, p, floor=max(scale, 1e-30) * 2.0 ** -10)
            if n:
                failures.append(f"{name}: {n} entries beyond 1 bf16 ulp of plain")
        elif not d <= BWD_TOLERANCE * scale:
            failures.append(f"{name}: max|d| {d:.3g} > {BWD_TOLERANCE} x {scale:.3g}")
    return err, failures
