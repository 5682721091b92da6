"""Port parity: the int8 MSDA of ``pairnet_torch`` against the JAX package's
int8 TPU kernels (v10-v14), run in interpret mode on the CPU.

The port's CUDA int8 kernels are held against these plain versions on the
GPU by ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import pairnet_tpu.ops.pallas_deform_attn_v10 as v10
import pairnet_tpu.ops.pallas_deform_attn_v11 as v11
import pairnet_tpu.ops.pallas_deform_attn_v12 as v12
import pairnet_tpu.ops.pallas_deform_attn_v14 as v14
from test_torch_helpers import msda_inputs
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops.deform_attn import bf16_ulps_off, ms_deform_attn  # noqa: E402
from pairnet_torch.ops.deform_attn_bwd import ms_deform_attn_bwd_plain  # noqa: E402
from pairnet_torch.ops.deform_attn_int8 import (  # noqa: E402
    int8_gather,
    int8_quantize,
)

SMALL = dict(B=1, H=2, D=8, Q=60, shapes=((6, 9), (3, 5), (2, 3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wild", [False, True])
def test_codes_and_scales_bit_equal_to_jax(dtype, wild):
    """Codes and scales equal JAX's ``_quantize_rows`` (bit-identical to
    v12's fused quantize) per level, on f32 and on bf16 values."""
    shapes, value, _, _ = msda_inputs(seed=11, wild=wild)
    vt = torch.tensor(value).to(getattr(torch, dtype))
    codes, scales = int8_quantize(vt, shapes)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    B, S, H, D = value.shape
    jv = jnp.asarray(vt.float().numpy()).astype(getattr(jnp, dtype))
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        vl = jv[:, start : start + h * w].transpose(0, 2, 3, 1).reshape(B * H, D, h * w)
        q, scale = v10._quantize_rows(vl)
        ref_codes = np.asarray(q).reshape(B, H, D, h * w).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(codes[:, start : start + h * w].numpy(), ref_codes)
        np.testing.assert_array_equal(scales[:, :, lvl].numpy(),
                                      np.asarray(scale).reshape(B, H, D))
        start += h * w


@pytest.mark.parametrize("kernel", ["v12", "v14"])
@pytest.mark.parametrize("wild", [False, True])
def test_gather_within_one_bf16_ulp_of_v12_v14(kernel, wild):
    """The "int8" impl on CPU tensors (plain quantize, plain gather, bf16
    out) against the TPU kernel in interpret mode: every output within one
    bf16 ulp (the two f32 sums differ in order before the one rounding)."""
    shapes, value, locs, w = msda_inputs(seed=12, wild=wild, Q=300)
    impl = {"v12": v12._ms_deform_attn_v12_impl, "v14": v14._ms_deform_attn_v14_impl}[kernel]
    with pltpu.force_tpu_interpret_mode():
        ref = impl(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w))
    ref = torch.tensor(np.asarray(ref.astype(jnp.float32))).to(torch.bfloat16)
    out = ms_deform_attn(torch.tensor(value), shapes, torch.tensor(locs), torch.tensor(w),
                         impl="int8")
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert bf16_ulps_off(out, ref) == 0


@pytest.mark.parametrize("kernel", ["v10", "v11"])
def test_f32_gather_matches_v10_v11(kernel):
    """The f32-output instance against the parity anchors (one level per
    call, the scale folded outside, f32 out) at a tiny size: within 1e-6
    of max |ref| (f32 sums in another order)."""
    shapes, value, locs, w = msda_inputs(seed=13, wild=True, **SMALL)
    impl = {"v10": v10._ms_deform_attn_v10_impl, "v11": v11._ms_deform_attn_v11_impl}[kernel]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(impl(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w)))
    codes, scales = int8_quantize(torch.tensor(value), shapes)
    out = int8_gather(codes, scales, shapes, torch.tensor(locs), torch.tensor(w), torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("bwd", ["exact", "bf16_grad"])
def test_int8_function_gradient_is_msda_backward(bwd):
    """The "int8" impl differentiates like v12's custom_vjp: the MSDA
    backward on the saved full-precision inputs, not on the codes."""
    shapes, value, locs, w = msda_inputs(seed=14, wild=True, **SMALL)
    v = torch.tensor(value).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (v, torch.tensor(locs), torch.tensor(w))]
    out = ms_deform_attn(*leaves[:1], shapes, *leaves[1:], impl="int8", bwd=bwd)
    g = torch.tensor(np.random.default_rng(15).normal(size=out.shape), dtype=torch.bfloat16)
    grads = torch.autograd.grad(out, leaves, g)
    ref = ms_deform_attn_bwd_plain(v, shapes, torch.tensor(locs), torch.tensor(w), g,
                                   bf16_grad=bwd == "bf16_grad")
    for got, want in zip(grads, ref):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
