"""The benchmark's seeded initialiser: every tensor of a model's
:func:`~portbench.reference.pairnet.param_specs`, made on the device from
one seed with a few large calls.

Kinds: ``fan_in`` N(0, 1 / fan-in) (lecun normal: linear, convolution and
attention projections), ``normal`` N(0, 1) (query and level tables),
``relpos`` 0.02 N(0, 1) cut at two sigma (Swin's relative-position
tables), ``offset_noise`` 0.05 N(0, 1) (the deformable attention's
sampling-offset and attention-weight kernels, which the published init
zeroes: the noise moves the taps off their grid), ``offset_grid:H:L:P``
(mmcv's sampling-offset bias: each head's direction on the unit square,
scaled by the point's index), ``zero`` and ``one``. Every draw comes from
one ``torch.Generator`` on ``device`` in one call, in spec order; the
tensors are returned in ``dtype``.
"""

from __future__ import annotations

import math

import torch

OFFSET_NOISE = 0.05
RELPOS_STD = 0.02


def offset_grid(H, L, P):
    theta = torch.arange(H, dtype=torch.float32) * (2 * math.pi / H)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    scale = torch.arange(1, P + 1, dtype=torch.float32)[None, None, :, None]
    return (grid[:, None, None, :] * scale).expand(H, L, P, 2).reshape(-1)


def make_weights(specs, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """name -> tensor for every spec, from ``seed``."""
    drawn = [n for n, shape, kind in specs if kind in ("fan_in", "normal", "relpos", "offset_noise")]
    sizes = {n: math.prod(shape) for n, shape, _ in specs}
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    noise = torch.randn(sum(sizes[n] for n in drawn), generator=g, device=device)
    out, start = {}, 0
    for name, shape, kind in specs:
        if kind in ("zero", "one"):
            out[name] = torch.full(shape, float(kind == "one"), device=device, dtype=dtype)
            continue
        if kind.startswith("offset_grid"):
            out[name] = offset_grid(*map(int, kind.split(":")[1:])).to(device, dtype)
            continue
        t = noise[start:start + sizes[name]].view(shape)
        start += sizes[name]
        if kind == "fan_in":
            t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "relpos":
            t = t.clamp(-2.0, 2.0) * RELPOS_STD
        elif kind == "offset_noise":
            t = t * OFFSET_NOISE
        elif kind != "normal":
            raise ValueError(f"{name}: unknown initialiser kind {kind!r}")
        out[name] = t.to(dtype)
    return out
