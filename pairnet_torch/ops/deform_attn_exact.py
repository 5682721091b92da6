"""Wrapper of the exact MSDA CUDA kernel (``csrc/deform_attn_exact.cu``) and
its autograd Function.

Replaces ``pairnet_tpu/ops/pallas_deform_attn_v6.py::_kernel`` (f32 values)
and ``pairnet_tpu/ops/pallas_deform_attn_v7.py::_kernel`` (bf16 values). The
kernel is bound by bytes on an H100; see the source note.

On a CPU tensor the wrapper runs the plain version,
:func:`pairnet_torch.ops.deform_attn.ms_deform_attn_plain`. On a CUDA
tensor it launches the kernel or raises.

:func:`ms_deform_attn_exact` is the differentiable entry, the counterpart of
the ``custom_vjp`` of ``ms_deform_attn_pallas_v6``/``_v7``: an
:class:`~pairnet_torch.ops.deform_attn_bwd.MSDAFunction`, whose backward is
the backward kernel on CUDA and its plain version on CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pairnet_torch.ops import _build
from pairnet_torch.ops.deform_attn import aligned, check_inputs, check_width, ms_deform_attn_plain
from pairnet_torch.ops.deform_attn_bwd import MSDAFunction

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
_FN = {torch.float32: "deform_attn_exact_f32", torch.bfloat16: "deform_attn_exact_bf16"}


@functools.cache
def _lib():
    lib = _build.load("deform_attn_exact")
    for name in _FN.values():
        getattr(lib, name).argtypes = _ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def deform_attn_exact(value, spatial_shapes, sampling_locations, attention_weights):
    """Exact MSDA: value f32 or bf16 with D a multiple of 8 up to 64 on
    CUDA, f32 output (B, Q, H * D)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"deform_attn_exact: unsupported device {value.device}")
    if value.dtype not in _FN:
        raise TypeError(f"deform_attn_exact: value dtype {value.dtype} is not f32 or bf16")
    check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = value.shape
    check_width(D, "deform_attn_exact")
    value, locs, weights = aligned(value, sampling_locations.float(), attention_weights.float())
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    out = torch.empty((B, Q, H * D), device=value.device, dtype=torch.float32)
    hw = _build.host_shapes(spatial_shapes)
    fn = getattr(_lib(), _FN[value.dtype])
    with torch.cuda.device(value.device):
        status = fn(
            value.data_ptr(), locs.data_ptr(), weights.data_ptr(), out.data_ptr(),
            B, S, Q, H, D, L, P, ctypes.addressof(hw),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "deform_attn_exact")
    deform_attn_exact.launches += 1
    return out


deform_attn_exact.launches = 0


def ms_deform_attn_exact(value, spatial_shapes, sampling_locations, attention_weights,
                         bwd: str = "exact"):
    """Differentiable exact MSDA, f32 output (B, Q, H * D); ``bwd`` is the
    backward variant (see :mod:`pairnet_torch.ops.deform_attn_bwd`)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDAFunction.apply(deform_attn_exact, value, sampling_locations, attention_weights,
                              spatial_shapes, bwd)
