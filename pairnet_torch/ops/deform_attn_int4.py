"""int4 MSDA for bf16 serving: wrappers of ``csrc/deform_attn_int4.cu``.

Replaces ``pairnet_tpu/ops/pallas_deform_attn_v16.py``: ``_qp16_kernel``
becomes :func:`int4_quantize` and ``_kernel`` becomes :func:`int4_gather`.
Both kernels are bound by bytes on an H100; see the source note.

* quantize: one scale per (b, h, level, d), ``max(absmax / 7, 1e-20)``;
  codes ``clip(round_half_even(v / scale), -7, 7)`` with an f32 divide.
  Codes are int8 in the value layout (B, S, H, D); scales f32 (B, H, L, D).
* gather: the exact MSDA on the codes, the scale folded in per
  (level, d), f32 accumulation, bf16 output (B, Q, H * D). Its semantic
  target is the exact MSDA on the dequantized values, then cast to bf16.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.

:func:`ms_deform_attn_int4` is differentiable, as the ``custom_vjp`` of
``ms_deform_attn_pallas_v16`` is: an
:class:`~pairnet_torch.ops.deform_attn_bwd.MSDAFunction` that saves the
full-precision value (not the codes), the locations and the weights, and
differentiates the exact MSDA on those (``pallas_deform_attn_v16.py:343-352``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pairnet_torch.ops import _build
from pairnet_torch.ops.deform_attn import check_inputs, level_starts, ms_deform_attn_plain
from pairnet_torch.ops.deform_attn_bwd import MSDAFunction

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("deform_attn_int4")
    lib.int4_quantize_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.int4_quantize_bf16.restype = ctypes.c_int
    lib.int4_gather.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.int4_gather.restype = ctypes.c_int
    return lib


def int4_quantize_plain(value, spatial_shapes):
    """Plain version of :func:`int4_quantize`: (codes int8, scales f32)."""
    B, S, H, D = value.shape
    offs = level_starts(spatial_shapes)
    v = value.float()
    # a tensor divisor keeps the divide IEEE on CUDA (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    seven = v.new_tensor(7.0)
    codes = torch.empty((B, S, H, D), dtype=torch.int8, device=value.device)
    scales = []
    for lvl in range(len(spatial_shapes)):
        vl = v[:, offs[lvl] : offs[lvl + 1]]
        scale = torch.clamp_min(vl.abs().amax(dim=1) / seven, 1e-20)  # (B, H, D)
        codes[:, offs[lvl] : offs[lvl + 1]] = torch.round(vl / scale[:, None]).clamp(-7, 7).to(
            torch.int8
        )
        scales.append(scale)
    return codes, torch.stack(scales, dim=2)


def int4_gather_plain(codes, scales, spatial_shapes, sampling_locations, attention_weights):
    """Plain version of :func:`int4_gather`: exact MSDA on the dequantized
    values (code * scale of its level), cast to bf16."""
    offs = level_starts(spatial_shapes)
    value = codes.float()
    for lvl in range(len(spatial_shapes)):
        value[:, offs[lvl] : offs[lvl + 1]] *= scales[:, None, :, lvl]
    out = ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    return out.to(torch.bfloat16)


def int4_quantize(value, spatial_shapes):
    """Per-(b, h, level, d) int4 quantization of the value plane; bf16
    values on the card (the plain version also takes f32)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return int4_quantize_plain(value, spatial_shapes)
    if value.device.type != "cuda":
        raise ValueError(f"int4_quantize: unsupported device {value.device}")
    if value.dtype != torch.bfloat16:
        raise TypeError(f"int4_quantize: value dtype {value.dtype} is not bf16")
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    if S != level_starts(spatial_shapes)[-1]:
        raise ValueError(f"int4_quantize: S={S} does not match levels {spatial_shapes}")
    value = value.contiguous()
    amax = torch.zeros((B, L, H, D), dtype=torch.int32, device=value.device)
    codes = torch.empty((B, S, H, D), dtype=torch.int8, device=value.device)
    scales = torch.empty((B, H, L, D), dtype=torch.float32, device=value.device)
    hw = _build.host_shapes(spatial_shapes)
    with torch.cuda.device(value.device):
        status = _lib().int4_quantize_bf16(
            value.data_ptr(), amax.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            B, S, H, D, L, ctypes.addressof(hw), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "int4_quantize")
    int4_quantize.launches += 1
    return codes, scales


def int4_gather(codes, scales, spatial_shapes, sampling_locations, attention_weights):
    """MSDA on int4 codes with the scales folded in; bf16 (B, Q, H * D)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if codes.device.type == "cpu":
        return int4_gather_plain(
            codes, scales, spatial_shapes, sampling_locations, attention_weights
        )
    if codes.device.type != "cuda":
        raise ValueError(f"int4_gather: unsupported device {codes.device}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("int4_gather: expects int8 codes and f32 scales")
    check_inputs(codes, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = codes.shape
    L = len(spatial_shapes)
    if scales.shape != (B, H, L, D) or scales.device != codes.device:
        raise ValueError(f"int4_gather: scales {tuple(scales.shape)} are not {(B, H, L, D)}")
    codes = codes.contiguous()
    scales = scales.contiguous()
    locs = sampling_locations.float().contiguous()
    weights = attention_weights.float().contiguous()
    Q, P = locs.shape[1], locs.shape[4]
    out = torch.empty((B, Q, H * D), dtype=torch.bfloat16, device=codes.device)
    hw = _build.host_shapes(spatial_shapes)
    with torch.cuda.device(codes.device):
        status = _lib().int4_gather(
            codes.data_ptr(), scales.data_ptr(), locs.data_ptr(), weights.data_ptr(),
            out.data_ptr(), B, S, Q, H, D, L, P, ctypes.addressof(hw),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "int4_gather")
    int4_gather.launches += 1
    return out


int4_quantize.launches = 0
int4_gather.launches = 0


def _int4_forward(value, spatial_shapes, locs, weights):
    codes, scales = int4_quantize(value, spatial_shapes)
    return int4_gather(codes, scales, spatial_shapes, locs, weights)


def ms_deform_attn_int4(value, spatial_shapes, sampling_locations, attention_weights,
                        bwd: str = "exact"):
    """int4 serving MSDA: quantize, then gather. bf16 (B, Q, H * D).
    Differentiable through the ``bwd`` variant of the MSDA backward."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDAFunction.apply(_int4_forward, value, sampling_locations, attention_weights,
                              spatial_shapes, bwd)
