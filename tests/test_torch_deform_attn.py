"""Port parity: the MSDA op of ``pairnet_torch`` against the JAX package.

The plain versions of the port's three CUDA kernels (exact MSDA, int4
quantize, int4 gather) are held against the JAX row-gather reference and
the TPU kernels run in interpret mode. The CUDA kernels themselves are
held against these plain versions on the GPU by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import pairnet_tpu.ops.pallas_deform_attn_v6 as v6
import pairnet_tpu.ops.pallas_deform_attn_v10 as v10
import pairnet_tpu.ops.pallas_deform_attn_v16 as v16
from pairnet_tpu.ops.deform_attn import ms_deform_attn as jax_msda
from test_torch_helpers import MSDA_SHAPES, QUANT_KINDS, msda_inputs, quantize_edge_values
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_plain  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import (  # noqa: E402
    int4_gather_plain,
    int4_quantize,
    int4_quantize_plain,
    ms_deform_attn_int4,
)
from pairnet_torch.ops.deform_attn_int8 import (  # noqa: E402
    int8_gather_plain,
    int8_quantize,
    int8_quantize_plain,
)


def _rows(shapes, value, locs, w):
    return np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(locs),
                               jnp.asarray(w), impl="rows"))


@pytest.mark.parametrize("wild", [False, True])
def test_plain_matches_rows(wild):
    """f32, tight and wild offsets (out-of-plane corners), atol 1e-5."""
    shapes, value, locs, w = msda_inputs(seed=1, wild=wild, Q=300)
    ref = _rows(shapes, value, locs, w)
    out = ms_deform_attn_plain(torch.tensor(value), shapes, torch.tensor(locs), torch.tensor(w))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_plain_on_bf16_values_matches_rows():
    """bf16 values (the v7 case): read exactly, summed in f32, f32 output."""
    shapes, value, locs, w = msda_inputs(seed=2, wild=True, Q=200)
    vb = torch.tensor(value).to(torch.bfloat16)
    ref = _rows(shapes, vb.float().numpy(), locs, w)
    out = ms_deform_attn_plain(vb, shapes, torch.tensor(locs), torch.tensor(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_plain_matches_v6_interpret():
    """One small run of the f32 TPU kernel in interpret mode, atol 1e-5."""
    shapes = ((6, 8), (3, 4))
    shapes, value, locs, w = msda_inputs(seed=4, wild=True, B=1, H=2, D=8, Q=40, P=2,
                                         shapes=shapes)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(v6._ms_deform_attn_v6_impl(
            jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w)))
    out = ms_deform_attn_plain(torch.tensor(value), shapes, torch.tensor(locs), torch.tensor(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def _v16_codes(shapes, value):
    """int4 codes of the TPU quantize kernel (``_quantize_pack_int4`` in
    interpret mode), unpacked to (B, S, H, D), with its (B, H, L, D) scales.
    The plane keeps the value's dtype and the scales come from its f32
    copy, as in ``_ms_deform_attn_v16_impl``."""
    B, S, H, D = value.shape
    blk = v16.BLK
    vT = jnp.asarray(value).transpose(0, 2, 3, 1).reshape(B * H, D, S)
    planes, scales, offs, pads, pos, start = [], [], [], [], 0, 0
    for h, w in shapes:
        n = h * w
        pad = -(-(n + blk) // blk) * blk
        vl = vT[:, :, start : start + n]
        scales.append(jnp.maximum(
            jnp.max(jnp.abs(vl.astype(jnp.float32)), axis=2, keepdims=True) / 7.0, 1e-20))
        planes.append(jnp.pad(vl, ((0, 0), (0, 0), (0, pad - n))))
        offs.append(pos)
        pads.append(pad)
        pos += pad
        start += n
    scales_dl = jnp.concatenate(scales, axis=2)  # (BH, D, L)
    with pltpu.force_tpu_interpret_mode():
        packed = np.asarray(v16._quantize_pack_int4(
            jnp.concatenate(planes, axis=2), scales_dl, shapes, tuple(offs), tuple(pads)))
    lo = (packed << 28) >> 28  # channel d, corner 00
    hi = (packed << 12) >> 28  # channel d + D/2, corner 00
    codes = np.concatenate([lo, hi], axis=1)  # (BH, D, S_pad)
    codes = np.concatenate(
        [codes[:, :, o : o + h * w] for o, (h, w) in zip(offs, shapes)], axis=2)
    codes = codes.reshape(B, H, D, S).transpose(0, 3, 1, 2)
    scales = np.asarray(scales_dl).reshape(B, H, D, len(shapes)).transpose(0, 1, 3, 2)
    return codes, scales


def test_int4_plain_matches_v16_interpret():
    """Codes and scales bit-equal to the TPU quantize kernel; the output
    within atol 2e-2 / rtol 1e-3 of the TPU gather kernel (its test's bound)."""
    shapes, value, locs, w = msda_inputs(seed=1, wild=False)
    ref_codes, ref_scales = _v16_codes(shapes, value)
    codes, scales = int4_quantize(torch.tensor(value), shapes)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy().astype(np.int32), ref_codes)
    np.testing.assert_array_equal(scales.numpy(), ref_scales)

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(v16._ms_deform_attn_v16_impl(
            jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w)), np.float32)
    out = ms_deform_attn_int4(torch.tensor(value), shapes, torch.tensor(locs), torch.tensor(w))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=1e-3)


def _rows_codes(shapes, value):
    """int8 codes and scales of the JAX package's row quantize
    (``v10._quantize_rows``, bit-identical to v12's fused kernel), level by
    level, as (B, S, H, D) codes and (B, H, L, D) scales."""
    B, S, H, D = value.shape
    codes, scales, start = [], [], 0
    for h, w in shapes:
        vl = value[:, start : start + h * w].transpose(0, 2, 3, 1).reshape(B * H, D, h * w)
        q, scale = v10._quantize_rows(vl)
        codes.append(np.asarray(q).reshape(B, H, D, h * w).transpose(0, 3, 1, 2))
        scales.append(np.asarray(scale).reshape(B, H, D))
        start += h * w
    return np.concatenate(codes, axis=1), np.stack(scales, axis=2)


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("bits", ["int4", "int8"])
def test_quantize_edge_values_match_jax(bits, kind):
    """The edge semantics the CUDA quantize is held to, on the plain
    version: bf16 values as serving hands them over, a channel zero over a
    level (-0.0 included: scale 1e-20, codes 0), and exact half-step ties
    beside +-absmax (round half to even, +-bound). Codes and scales
    bit-equal to the JAX package's: the int4 TPU kernel in interpret mode,
    the int8 row quantize."""
    bound = 7 if bits == "int4" else 127
    value = quantize_edge_values(kind, bound, seed=21)
    bf16 = kind == "bf16"
    vt = torch.tensor(value).to(torch.bfloat16 if bf16 else torch.float32)
    jv = jnp.asarray(value).astype(jnp.bfloat16 if bf16 else jnp.float32)
    quantize, reference = {"int4": (int4_quantize, _v16_codes),
                           "int8": (int8_quantize, _rows_codes)}[bits]
    codes, scales = quantize(vt, MSDA_SHAPES)
    ref_codes, ref_scales = reference(MSDA_SHAPES, jv)
    np.testing.assert_array_equal(codes.numpy().astype(np.int32), ref_codes)
    np.testing.assert_array_equal(scales.numpy(), ref_scales)
    sizes = [h * w for h, w in MSDA_SHAPES]
    per_token = np.repeat(scales.numpy().transpose(0, 2, 1, 3), sizes, axis=1)  # (B, S, H, D)
    if kind == "zero_channel":
        zero = 0
        for lvl, (a, b) in enumerate(zip(np.cumsum([0] + sizes), np.cumsum(sizes))):
            z = np.all(value[:, a:b] == 0, axis=1)  # (B, H, D)
            assert np.all(scales.numpy()[:, :, lvl][z] == np.float32(1e-20))
            assert not codes[:, a:b].numpy().transpose(0, 2, 3, 1)[z].any()
            zero += int(z.sum())
        assert zero == 3  # (h 1, d 3) of level 1 in both images, (h 0, d 0) of level 2 in one
    if kind == "ties":
        q = value / per_token
        assert np.all(np.abs(q) <= bound) and np.all((np.abs(q) == bound) | (q % 1 == 0.5))
        np.testing.assert_array_equal(codes.numpy(), np.rint(q))


@pytest.mark.parametrize("impl", [None, "exact", "int4", "int8", "plain"])
def test_cpu_dispatch_takes_plain(impl):
    """On CPU tensors every impl computes what it computes on the card,
    through its kernels' plain versions: the exact impls the plain MSDA,
    "int4" and "int8" their quantize, then their gather (bf16 out)."""
    shapes, value, locs, w = msda_inputs(seed=6, B=1, H=2, D=8, Q=50)
    v, lc, wt = torch.tensor(value), torch.tensor(locs), torch.tensor(w)
    out = ms_deform_attn(v, shapes, lc, wt, impl=impl)
    if impl in ("int4", "int8"):
        quantize, gather = {"int4": (int4_quantize_plain, int4_gather_plain),
                            "int8": (int8_quantize_plain, int8_gather_plain)}[impl]
        want = gather(*quantize(v, shapes), shapes, lc, wt)
        assert out.dtype == torch.bfloat16
        assert not torch.equal(out.float(), ms_deform_attn_plain(v, shapes, lc, wt))
    else:
        want = ms_deform_attn_plain(v, shapes, lc, wt)
    assert torch.equal(out, want)


def test_unknown_impl_raises():
    shapes, value, locs, w = msda_inputs(seed=6, B=1, H=2, D=8, Q=10)
    with pytest.raises(ValueError, match="unknown ms_deform_attn impl"):
        ms_deform_attn(torch.tensor(value), shapes, torch.tensor(locs), torch.tensor(w),
                       impl="pallas_v16")
