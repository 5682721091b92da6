"""The least work of the MSDA sampling step and of its backward, from
shapes alone, whatever implements them.

Forward: the step's own inputs read once (the value plane, the sampling
locations, the attention weights) and its output written once; ~10
operations a (query, head, channel, level, point) tap. Backward (PERF.md
§6 row 6): the value plane, locations, weights and upstream gradient read
once, the three gradients written once; 4 operations a bilinear corner and
channel (one FMA for the corner's dot with the gradient, a multiply and an
add into dvalue), every corner counted. The least time is the larger of
bytes over the HBM rate and operations over the float32 rate (the taps run
outside the tensor cores), on the published peaks of one H100 SXM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _taps(B, Q, H, L, P):
    return B * Q * H * L * P


def forward_bytes(B, shapes, H, D, L, P, Q=None, value=2, locs=4, weights=2, out=2):
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    t = _taps(B, Q, H, L, P)
    return B * S * H * D * value + t * 2 * locs + t * weights + B * Q * H * D * out


def forward_ops(B, shapes, H, D, L, P, Q=None):
    Q = sum(h * w for h, w in shapes) if Q is None else Q
    return 10 * _taps(B, Q, H, L, P) * D


def backward_bytes(B, shapes, H, D, L, P, Q=None, value=2, locs=4, weights=2, grad=4):
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    t = _taps(B, Q, H, L, P)
    inputs = B * S * H * D * value + t * 2 * locs + t * weights + B * Q * H * D * grad
    outputs = B * S * H * D * value + t * 2 * locs + t * weights
    return inputs + outputs


def backward_ops(B, shapes, H, D, L, P, Q=None):
    Q = sum(h * w for h, w in shapes) if Q is None else Q
    return 4 * 4 * _taps(B, Q, H, L, P) * D


def least_seconds(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def encoder_shapes(image_hw, strides=(32, 16, 8)):
    """The pixel decoder's levels, low to high resolution."""
    return tuple((image_hw[0] // s, image_hw[1] // s) for s in strides)
