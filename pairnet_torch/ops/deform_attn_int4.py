"""int4 MSDA for bf16 serving: wrappers of ``csrc/deform_attn_quant.cu``.

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
launch the kernels or raise. The launchers here also serve the int8
instances of the same source (``ops/deform_attn_int8.py``).

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
from pairnet_torch.ops.deform_attn import (
    aligned,
    check_inputs,
    check_width,
    level_starts,
    ms_deform_attn_plain,
)
from pairnet_torch.ops.deform_attn_bwd import MSDAFunction

_P = ctypes.c_void_p
_I = ctypes.c_int
QUANTIZE_FNS = ("int4_quantize_bf16", "int8_quantize_bf16", "int8_quantize_f32")
GATHER_FNS = ("int4_gather", "int8_gather_bf16", "int8_gather_f32")


@functools.cache
def _lib():
    lib = _build.load("deform_attn_quant")
    for name in QUANTIZE_FNS:
        getattr(lib, name).argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        getattr(lib, name).restype = ctypes.c_int
    for name in GATHER_FNS:
        getattr(lib, name).argtypes = [_P] * 5 + [_I] * 8 + [_P, _P]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def quantize_plain(value, spatial_shapes, bound: int):
    """Per-(b, h, level, d) quantization to codes in [-bound, bound]:
    (codes int8 (B, S, H, D), scales f32 (B, H, L, D))."""
    B, S, H, D = value.shape
    offs = level_starts(spatial_shapes)
    v = value.float()
    # a tensor divisor keeps the divide IEEE on CUDA (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    divisor = v.new_tensor(float(bound))
    codes = torch.empty((B, S, H, D), dtype=torch.int8, device=value.device)
    scales = []
    for lvl in range(len(spatial_shapes)):
        vl = v[:, offs[lvl] : offs[lvl + 1]]
        scale = torch.clamp_min(vl.abs().amax(dim=1) / divisor, 1e-20)  # (B, H, D)
        codes[:, offs[lvl] : offs[lvl + 1]] = torch.round(vl / scale[:, None]).clamp(
            -bound, bound).to(torch.int8)
        scales.append(scale)
    return codes, torch.stack(scales, dim=2)


def int4_quantize_plain(value, spatial_shapes):
    """Plain version of :func:`int4_quantize`: (codes int8, scales f32)."""
    return quantize_plain(value, spatial_shapes, 7)


def int4_gather_plain(codes, scales, spatial_shapes, sampling_locations, attention_weights):
    """Plain version of :func:`int4_gather`: exact MSDA on the dequantized
    values (code * scale of its level), cast to bf16."""
    offs = level_starts(spatial_shapes)
    value = codes.float()
    for lvl in range(len(spatial_shapes)):
        value[:, offs[lvl] : offs[lvl + 1]] *= scales[:, None, :, lvl]
    out = ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    return out.to(torch.bfloat16)


_workspaces: dict = {}  # (device index, stream) -> the quantize's u32 workspace
_outgrown: list = []  # the workspaces larger ones replaced, never freed


def quantize_workspace(device, stream: int, n: int):
    """The quantize's workspace on ``device`` for calls on ``stream``: at
    least ``n`` int32 entries, zeroed when allocated (once, or when a call
    needs more) and left zero by every call, so a call launches no fill.
    One that a larger one replaces is kept, since a CUDA graph captured
    with it still reads it; a capture on ``stream`` may not allocate one,
    so warm up first."""
    ws = _workspaces.get((device.index, stream))
    if ws is None or ws.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize: no workspace of this size for the capturing "
                               "stream; run the call once on that stream before capture")
        if ws is not None:
            _outgrown.append(ws)
        ws = torch.zeros(n, dtype=torch.int32, device=device)
        _workspaces[(device.index, stream)] = ws
    return ws


def launch_quantize(fn: str, what: str, value, spatial_shapes):
    """Launch the quantize entry ``fn`` of the library on a CUDA value of
    the layout (B, S, H, D) and of the dtype that ``fn`` names (``_bf16``
    or ``_f32``), D a multiple of 8: (codes int8, scales f32 (B, H, L, D))."""
    if value.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {value.device}")
    want = torch.bfloat16 if fn.endswith("_bf16") else torch.float32
    if value.dtype != want:
        raise TypeError(f"{what}: value dtype {value.dtype} is not {want}")
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    if S != level_starts(spatial_shapes)[-1]:
        raise ValueError(f"{what}: S={S} does not match levels {spatial_shapes}")
    if D % 8:
        raise ValueError(f"{what}: the kernel takes D a multiple of 8, not {D}")
    (value,) = aligned(value)
    codes = torch.empty((B, S, H, D), dtype=torch.int8, device=value.device)
    scales = torch.empty((B, H, L, D), dtype=torch.float32, device=value.device)
    hw = _build.host_shapes(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = quantize_workspace(value.device, stream, B * L * (H * D + 1))
        status = getattr(_lib(), fn)(
            value.data_ptr(), ws.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            B, S, H, D, L, ctypes.addressof(hw), stream,
        )
    _build.check(status, what)
    return codes, scales


def launch_gather(fn: str, what: str, out_dtype, codes, scales, spatial_shapes,
                  sampling_locations, attention_weights):
    """Launch the gather entry ``fn`` on CUDA codes and scales: an
    ``out_dtype`` tensor (B, Q, H * D). The kernel reads bf16 or f32
    attention weights as they come; D is a multiple of 8 up to 64."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{what}: expects int8 codes and f32 scales")
    check_inputs(codes, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = codes.shape
    L = len(spatial_shapes)
    if scales.shape != (B, H, L, D) or scales.device != codes.device:
        raise ValueError(f"{what}: scales {tuple(scales.shape)} are not {(B, H, L, D)}")
    check_width(D, what)
    weights = attention_weights
    if weights.dtype != torch.bfloat16:
        weights = weights.float()
    codes, scales, locs, weights = aligned(codes, scales, sampling_locations.float(), weights)
    Q, P = locs.shape[1], locs.shape[4]
    out = torch.empty((B, Q, H * D), dtype=out_dtype, device=codes.device)
    hw = _build.host_shapes(spatial_shapes)
    with torch.cuda.device(codes.device):
        status = getattr(_lib(), fn)(
            codes.data_ptr(), scales.data_ptr(), locs.data_ptr(), weights.data_ptr(),
            out.data_ptr(), B, S, Q, H, D, L, P, int(weights.dtype == torch.bfloat16),
            ctypes.addressof(hw),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, what)
    return out


def int4_quantize(value, spatial_shapes):
    """Per-(b, h, level, d) int4 quantization of the value plane; bf16
    values on the card (the plain version also takes f32)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return int4_quantize_plain(value, spatial_shapes)
    out = launch_quantize("int4_quantize_bf16", "int4_quantize", value, spatial_shapes)
    int4_quantize.launches += 1
    return out


def int4_gather(codes, scales, spatial_shapes, sampling_locations, attention_weights):
    """MSDA on int4 codes with the scales folded in; bf16 (B, Q, H * D)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if codes.device.type == "cpu":
        return int4_gather_plain(
            codes, scales, spatial_shapes, sampling_locations, attention_weights
        )
    out = launch_gather("int4_gather", "int4_gather", torch.bfloat16, codes, scales,
                        spatial_shapes, sampling_locations, attention_weights)
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
