"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them.
On a GPU machine: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
"""

import numpy as np
import pytest

from test_torch_helpers import msda_inputs

torch = pytest.importorskip("torch")

from pairnet_torch.ops.deform_attn import (  # noqa: E402
    bf16_ulps_off,
    ms_deform_attn,
    ms_deform_attn_plain,
)
from pairnet_torch.ops.deform_attn_bwd import (  # noqa: E402
    bwd_mismatch,
    deform_attn_bwd,
    ms_deform_attn_bwd_plain,
)
from pairnet_torch.ops.deform_attn_exact import deform_attn_exact  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import (  # noqa: E402
    int4_gather,
    int4_gather_plain,
    int4_quantize,
    int4_quantize_plain,
)
from pairnet_torch.ops.deform_attn_int8 import (  # noqa: E402
    int8_gather,
    int8_gather_plain,
    int8_quantize,
    int8_quantize_plain,
)
from pairnet_torch.ops.masked_attn import (  # noqa: E402
    chunk_keys,
    masked_flash_attention,
    masked_flash_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shapes, value, locs, w = msda_inputs(seed=request.param, wild=True)
    dev = torch.device("cuda")
    return shapes, torch.tensor(value, device=dev), torch.tensor(locs, device=dev), \
        torch.tensor(w, device=dev)


@pytest.mark.parametrize("cuda_inputs", [0], indirect=True)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_kernel_matches_plain(cuda_inputs, dtype):
    shapes, value, locs, w = cuda_inputs
    value = value.to(getattr(torch, dtype))
    n = deform_attn_exact.launches
    out = deform_attn_exact(value, shapes, locs, w)
    assert deform_attn_exact.launches == n + 1 and out.dtype == torch.float32
    ref = ms_deform_attn_plain(value, shapes, locs, w)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cuda_inputs", [1], indirect=True)
def test_int4_kernels_match_plain(cuda_inputs):
    shapes, value, locs, w = cuda_inputs
    value = value.to(torch.bfloat16)
    codes, scales = int4_quantize(value, shapes)
    ref_codes, ref_scales = int4_quantize_plain(value, shapes)
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
    out = int4_gather(codes, scales, shapes, locs, w)
    ref = int4_gather_plain(codes, scales, shapes, locs, w)
    assert bf16_ulps_off(out, ref) == 0


@pytest.mark.parametrize("cuda_inputs", [5], indirect=True)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernels_match_plain(cuda_inputs, dtype):
    """Codes and scales bit-equal on bf16 and f32 values; the bf16-output
    gather within 1 bf16 ulp, the f32-output one within 1e-4 x max|plain|."""
    shapes, value, locs, w = cuda_inputs
    value = value.to(getattr(torch, dtype))
    codes, scales = int8_quantize(value, shapes)
    ref_codes, ref_scales = int8_quantize_plain(value, shapes)
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
    out = int8_gather(codes, scales, shapes, locs, w)
    assert out.dtype == torch.bfloat16
    assert bf16_ulps_off(out, int8_gather_plain(codes, scales, shapes, locs, w)) == 0
    out = int8_gather(codes, scales, shapes, locs, w, torch.float32)
    ref = int8_gather_plain(codes, scales, shapes, locs, w, torch.float32)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("Lk", [2048, 4200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attn_kernel_matches_plain(Lk, dtype):
    """A head-shared mask about half set, whole 1024-key spans masked in
    some rows, a live key in every row; max |kernel - plain| <= 1e-5 (the
    outputs are averages of N(0, 1) values; the two differ by the order of
    their f32 sums and, in bf16, by the ~2^-18 relative residual of P's
    hi/lo split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(Lk)
    B, H, Lq, D = 2, 8, 100, 32
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.normal(size=(B * H, n, D)), dtype=torch.float32).to(dt)
               for n in (Lq, Lk, Lk))
    mask = rng.uniform(size=(B, Lq, Lk)) < 0.5
    mask[:, ::7, :1024] = True
    mask[:, np.arange(Lq), rng.integers(0, Lk, Lq)] = False
    mask = torch.tensor(mask)
    n = masked_flash_attention.launches
    out = masked_flash_attention(q.cuda(), k.cuda(), v.cuda(), mask.cuda(), H)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == n + 1 and out.dtype == torch.float32
    ref = masked_flash_attention_plain(q, k, v, mask, H)
    assert float((out.cpu() - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("H, D", [(4, 8), (4, 32), (8, 8), (8, 32)])
@pytest.mark.parametrize("gather", ["int4", "int8 bf16", "int8 f32"])
def test_gather_kernels_heads_and_widths(H, D, gather):
    """The warp-per-query gathers at H in {4, 8} and D in {8, 32}, with bf16
    attention weights as the serving path hands them over: bf16 out within 1
    bf16 ulp of plain, f32 out within 1e-4 x max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shapes, value, locs, w = msda_inputs(seed=6, wild=True, H=H, D=D)
    value, locs = torch.tensor(value, device="cuda"), torch.tensor(locs, device="cuda")
    w = torch.tensor(w, device="cuda").to(torch.bfloat16)
    if gather == "int4":
        codes, scales = int4_quantize_plain(value, shapes)
        out = int4_gather(codes, scales, shapes, locs, w)
        ref = int4_gather_plain(codes, scales, shapes, locs, w)
    else:
        out_dtype = torch.bfloat16 if gather == "int8 bf16" else torch.float32
        codes, scales = int8_quantize_plain(value, shapes)
        out = int8_gather(codes, scales, shapes, locs, w, out_dtype)
        ref = int8_gather_plain(codes, scales, shapes, locs, w, out_dtype)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (value.shape[0], locs.shape[1], H * D)
    if out.dtype == torch.bfloat16:
        assert bf16_ulps_off(out, ref) == 0
    else:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("D", [8, 32])
@pytest.mark.parametrize("Lq", [1, 17, 100])
@pytest.mark.parametrize("Lk", [2049, 4200, 16800])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attn_kernel_edge_cases(Lk, Lq, D, dtype):
    """The chunked tensor-core kernel against the plain version on the
    card, N(0, 1) x 5 inputs: a head-shared mask about half set, one row
    masked everywhere (it averages all values), the second key chunk wholly
    masked in every row, a live key elsewhere in every other row. Within
    1e-4 x max(1, max|plain|), chip_smoke.py's TOL_FLASH."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(Lk + Lq + D)
    B, H = 2, 8
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(5 * rng.normal(size=(B * H, n, D)), dtype=torch.float32,
                            device="cuda").to(dt) for n in (Lq, Lk, Lk))
    ck = chunk_keys(B, Lk, torch.cuda.get_device_properties(0).multi_processor_count)
    mask = rng.uniform(size=(B, Lq, Lk)) < 0.5
    mask[:, :, ck : 2 * ck] = True
    live = rng.integers(0, Lk - ck, (B, Lq))
    live = np.where(live >= ck, live + ck, live)  # outside the masked chunk
    mask[np.arange(B)[:, None], np.arange(Lq)[None], live] = False
    mask[:, Lq // 2] = True
    mask = torch.tensor(mask, device="cuda")
    n = masked_flash_attention.launches
    out = masked_flash_attention(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == n + 1 and out.dtype == torch.float32
    ref = masked_flash_attention_plain(q, k, v, mask, H)
    assert float((out - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("cuda_inputs", [2], indirect=True)
@pytest.mark.parametrize("D", [32, 8])
@pytest.mark.parametrize("inst", ["f32", "bf16", "bf16_grad"])
def test_bwd_kernel_matches_plain(cuda_inputs, D, inst):
    """Each backward instance against its plain version, at the flagship's
    head width D = 32 and the tiny model's D = 8."""
    shapes, value, locs, w = cuda_inputs
    value = value[..., :D].to(torch.float32 if inst == "f32" else torch.bfloat16)
    B, Q, H = locs.shape[:3]
    g = torch.randn((B, Q, H * D), generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda")
    bwd = "bf16_grad" if inst == "bf16_grad" else "exact"
    n = deform_attn_bwd.launches[inst]
    out = deform_attn_bwd(value, shapes, locs, w, g, bwd)
    torch.cuda.synchronize()
    assert deform_attn_bwd.launches[inst] == n + 1
    ref = ms_deform_attn_bwd_plain(value, shapes, locs, w, g, bf16_grad=bwd == "bf16_grad")
    err, failures = bwd_mismatch(out, ref)
    assert not failures, (err, failures)


@pytest.mark.parametrize("cuda_inputs", [3], indirect=True)
@pytest.mark.parametrize("impl", ["exact", "int4", "int8"])
def test_autograd_reaches_bwd_kernel(cuda_inputs, impl):
    """A backward through the forward kernels launches the backward kernel
    once and gives the plain version's gradients of value, locations and
    weights."""
    shapes, value, locs, w = cuda_inputs
    value = value.to(torch.bfloat16)
    g = torch.randn((*locs.shape[:2], value.shape[2] * value.shape[3]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    leaves = [t.clone().requires_grad_() for t in (value, locs, w)]
    n = deform_attn_bwd.launches["bf16"]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2], impl=impl)
    grads = torch.autograd.grad(out, leaves, g.to(out.dtype))
    assert deform_attn_bwd.launches["bf16"] == n + 1
    ref = ms_deform_attn_bwd_plain(value, shapes, locs, w, g.to(out.dtype))
    err, failures = bwd_mismatch(grads, ref)
    assert not failures, (err, failures)
