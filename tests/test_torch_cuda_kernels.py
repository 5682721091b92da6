"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them.
The NMS kernel (``csrc/nms.cu``) is held here against the plain sweep; the
plain sweep itself against JAX's in ``test_torch_twostage_ops.py``.
On a GPU machine: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
"""

import numpy as np
import pytest

from test_torch_helpers import (
    QUANT_KINDS,
    msda_border_inputs,
    msda_hotspot_inputs,
    msda_inputs,
    quantize_edge_values,
)
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

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
from pairnet_torch.ops.deform_attn_int4 import quantize_plain  # noqa: E402
from pairnet_torch.ops.deform_attn_int8 import (  # noqa: E402
    int8_gather,
    int8_gather_plain,
    int8_quantize,
    int8_quantize_plain,
)
from pairnet_torch.ops.hungarian import (  # noqa: E402
    MAX_COLS,
    SHORT_COLS,
    batched_hungarian,
    batched_hungarian_plain,
    prepare,
    solve_n_le_m_cuda,
    solve_n_le_m_plain_steps,
)
from pairnet_torch.ops import nms  # noqa: E402
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


def _on_card(*arrays):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return tuple(torch.tensor(a, device="cuda") for a in arrays)


@pytest.mark.parametrize("H, D", [(4, 8), (4, 32), (8, 8), (8, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_kernel_matches_plain(H, D, dtype):
    """The warp-per-query exact forward at H in {4, 8} and D in {8, 32},
    wild offsets: within 1e-5 of the plain version (f32 sums of ~50 taps of
    N(0, 1) values, the same products in another association)."""
    shapes, value, locs, w = msda_inputs(seed=0, wild=True, H=H, D=D)
    value, locs, w = _on_card(value, locs, w)
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


# quantize instance -> (wrapper, value dtype, code bound, its launch count)
QUANTIZE = {
    "int4 bf16": (int4_quantize, torch.bfloat16, 7, lambda: int4_quantize.launches),
    "int8 bf16": (int8_quantize, torch.bfloat16, 127, lambda: int8_quantize.launches["bf16"]),
    "int8 f32": (int8_quantize, torch.float32, 127, lambda: int8_quantize.launches["f32"]),
}
LEVELS_800x1344 = ((25, 42), (50, 84), (100, 168))  # 1050, 4200, 16800 tokens


def _quantize_case(inst, value, shapes):
    """The kernel's codes and scales on ``value`` (numpy or a CUDA tensor)
    in the instance's dtype, checked bit-equal to the plain version on the
    same tensor, with one launch counted."""
    quantize, dtype, bound, launches = QUANTIZE[inst]
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v = torch.as_tensor(value, device="cuda").to(dtype)
    n = launches()
    codes, scales = quantize(v, shapes)
    torch.cuda.synchronize()
    assert launches() == n + 1
    ref_codes, ref_scales = quantize_plain(v, shapes, bound)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
    return codes, scales


@pytest.mark.parametrize("H, D", [(4, 8), (4, 32), (8, 8), (8, 32)])
@pytest.mark.parametrize("inst", QUANTIZE)
def test_quantize_kernel_heads_and_widths(H, D, inst):
    """Each quantize instance at H in {4, 8} and D in {8, 32}, on levels of
    600, 150 and 40 tokens (each ending in a partial tile): bit-equal to the
    plain version."""
    shapes, value, _, _ = msda_inputs(seed=20, H=H, D=D, Q=1)
    _quantize_case(inst, value, shapes)


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("inst", QUANTIZE)
def test_quantize_kernel_edge_values(inst, kind):
    """bf16-rounded values, channels zero over a level (-0.0 included:
    scale 1e-20, codes 0), exact half-step ties (to even) beside +-absmax
    (+-bound): bit-equal to the plain version."""
    bound = QUANTIZE[inst][2]
    value = quantize_edge_values(kind, bound, seed=22)
    codes, _ = _quantize_case(inst, value, ((20, 30), (10, 15), (5, 8)))
    if kind == "ties":
        assert int(codes.abs().max()) == bound


@pytest.mark.parametrize("inst", QUANTIZE)
def test_quantize_kernel_many_tiles(inst):
    """The 800x1344 encoder levels at batch 2 (levels of 5, 17 and 66
    tiles, each with a partial last tile): bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    S = sum(h * w for h, w in LEVELS_800x1344)
    g = torch.Generator(device="cuda").manual_seed(23)
    value = torch.randn((2, S, 8, 32), generator=g, device="cuda")
    _quantize_case(inst, value, LEVELS_800x1344)


@pytest.mark.parametrize("inst", QUANTIZE)
def test_quantize_kernel_workspace_is_clean_for_the_next_call(inst):
    """Calls in a row on one stream share the workspace: a call at the same
    shape on smaller values (a maximum left over would show in its scales),
    then other levels, batches and widths, then the first call again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(24)
    small = ((20, 30), (10, 15), (5, 8))
    calls = [(small, 2, 8, 32, 4.0), (small, 2, 8, 32, 0.5), (LEVELS_800x1344, 3, 8, 32, 1.0),
             (((7, 9), (3, 3)), 1, 4, 8, 2.0), (small, 2, 8, 32, 4.0)]
    for shapes, B, H, D, amp in calls:
        S = sum(h * w for h, w in shapes)
        value = amp * torch.randn((B, S, H, D), generator=g, device="cuda")
        _quantize_case(inst, value, shapes)


@pytest.mark.parametrize("H", [3, 4])
@pytest.mark.parametrize("inst", QUANTIZE)
def test_quantize_kernel_raises_for_width_not_multiple_of_8(inst, H):
    """D = 6 (H * D 18 or 24): a thread's 8 channels would span two heads
    and H * D = 18 cannot take 16-byte loads, so the wrapper raises before
    any launch."""
    quantize, dtype, _, launches = QUANTIZE[inst]
    shapes, value, _, _ = msda_inputs(seed=25, H=H, D=6, Q=1)
    (v,) = _on_card(value)
    n = launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        quantize(v.to(dtype), shapes)
    assert launches() == n


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


def _bwd_case(shapes, value, locs, w, inst, seed=3):
    """(kernel, plain) backward of instance ``inst`` on CUDA copies of the
    inputs, with a seeded N(0, 1) upstream grad; checks the launch count."""
    value, locs, w = _on_card(value, locs, w)
    value = value.to(torch.float32 if inst == "f32" else torch.bfloat16)
    B, Q, H = locs.shape[:3]
    g = torch.randn((B, Q, H * value.shape[3]),
                    generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
    bwd = "bf16_grad" if inst == "bf16_grad" else "exact"
    n = deform_attn_bwd.launches[inst]
    out = deform_attn_bwd(value, shapes, locs, w, g, bwd)
    torch.cuda.synchronize()
    assert deform_attn_bwd.launches[inst] == n + 1
    return out, ms_deform_attn_bwd_plain(value, shapes, locs, w, g, bf16_grad=bwd == "bf16_grad")


INSTANCES = ["f32", "bf16", "bf16_grad"]


@pytest.mark.parametrize("H, D", [(4, 8), (4, 32), (8, 8), (8, 32)])
@pytest.mark.parametrize("inst", INSTANCES)
def test_bwd_kernel_matches_plain(H, D, inst):
    """Each backward instance against its plain version at H in {4, 8} and
    D in {8, 32} (the tiny model's and the flagship's head widths), wild
    offsets: f32 outputs within BWD_TOLERANCE x max|plain|, a bf16 dvalue
    within 1 bf16 ulp."""
    shapes, value, locs, w = msda_inputs(seed=2, wild=True, H=H, D=D)
    out, ref = _bwd_case(shapes, value, locs, w, inst)
    err, failures = bwd_mismatch(out, ref)
    assert not failures, (err, failures)


@pytest.mark.parametrize("inst", INSTANCES)
def test_bwd_kernel_hot_spot(inst):
    """Every tap of 700 queries in one pixel cell per level: the four
    corner rows of each level and head take ~2800 contended vector atomics
    each."""
    out, ref = _bwd_case(*msda_hotspot_inputs(seed=7), inst)
    err, failures = bwd_mismatch(out, ref)
    assert not failures, (err, failures)


@pytest.mark.parametrize("inst", INSTANCES)
def test_bwd_kernel_border(inst):
    """Taps at x0 = -1, x0 = w - 1, on integer pixels and wholly off the
    plane: the kernel matches the plain version, and a tap with no corner
    in the plane has dlocs and dweights exactly 0."""
    shapes, value, locs, w, off = msda_border_inputs(seed=8)
    assert 0 < off.sum() < off.size
    out, ref = _bwd_case(shapes, value, locs, w, inst)
    err, failures = bwd_mismatch(out, ref)
    assert not failures, (err, failures)
    off = torch.tensor(off, device="cuda")
    assert not out[1][off].any() and not out[2][off].any()


@pytest.mark.parametrize("inst", INSTANCES)
def test_bwd_kernel_all_off_plane(inst):
    """Every tap wholly off its plane: dvalue, dlocs and dweights exactly 0."""
    shapes, value, locs, w, off = msda_border_inputs(seed=9, all_off=True)
    assert off.all()
    out, _ = _bwd_case(shapes, value, locs, w, inst)
    assert not any(t.any() for t in out)


@pytest.mark.parametrize("inst", INSTANCES)
def test_bwd_kernel_decoder_queries(inst):
    """Q != S, as in a decoder: 37 queries (a partial block of warps), 3
    points per level (a partial group of taps in flight), wild offsets;
    the exact forward on the same inputs too."""
    shapes, value, locs, w = msda_inputs(seed=10, wild=True, Q=37, P=3)
    out, ref = _bwd_case(shapes, value, locs, w, inst)
    err, failures = bwd_mismatch(out, ref)
    assert not failures, (err, failures)
    v, lc, wt = _on_card(value, locs, w)
    v = v.to(torch.float32 if inst == "f32" else torch.bfloat16)
    np.testing.assert_allclose(deform_attn_exact(v, shapes, lc, wt).cpu().numpy(),
                               ms_deform_attn_plain(v, shapes, lc, wt).cpu().numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [12, 72])
def test_exact_and_bwd_raise_for_unsupported_width(D):
    """A head width that is not a multiple of 8 up to 64 raises before any
    launch, in the forward and the backward wrapper."""
    shapes, value, locs, w = msda_inputs(seed=11, D=D, Q=8)
    value, locs, w = _on_card(value, locs, w)
    g = torch.zeros((*locs.shape[:2], value.shape[2] * D), device="cuda")
    n_fwd, n_bwd = deform_attn_exact.launches, sum(deform_attn_bwd.launches.values())
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        deform_attn_exact(value, shapes, locs, w)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        deform_attn_bwd(value, shapes, locs, w, g)
    assert deform_attn_exact.launches == n_fwd
    assert sum(deform_attn_bwd.launches.values()) == n_bwd


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


def _hungarian_case(kind, B, n, m, seed):
    """(cost, row_mask, col_mask) numpy inputs of one Hungarian GPU case."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        cost = rng.integers(0, 4, size=(B, n, m)).astype(np.float32)
    else:
        cost = rng.normal(size=(B, n, m)).astype(np.float32)
    row_mask = np.ones((B, n), bool)
    col_mask = np.ones((B, m), bool)
    if kind == "padded":
        row_mask[1::2, n - n // 3:] = False
        col_mask[::2, m - m // 4:] = False
        cost[~row_mask] = 1e9
        cost.transpose(0, 2, 1)[~col_mask] = -1e9
    if kind == "nan_entry":
        cost[:, n // 2, m // 3] = np.nan
    return cost, row_mask, col_mask


def _hungarian_on_card(cost, row_mask, col_mask):
    """Kernel (CUDA tensors) and plain loop (CPU tensors) on the same inputs:
    both results as numpy, and the kernel launches of the call."""
    c, r, k = _on_card(cost, row_mask, col_mask)
    launches, syncs = batched_hungarian.launches, batched_hungarian.syncs
    got = batched_hungarian(c, r, k)
    torch.cuda.synchronize()
    assert batched_hungarian.syncs == syncs, "the kernel path synced with the host"
    n_launch = batched_hungarian.launches - launches
    want = batched_hungarian_plain(torch.tensor(cost), torch.tensor(row_mask),
                                   torch.tensor(col_mask))
    return [t.cpu().numpy() for t in got], [t.numpy() for t in want], n_launch


def _steps_match_plain(cost, row_mask, col_mask):
    """The kernel on the prepared costs against the plain loop: row2col and
    the search steps of every problem, bit for bit."""
    pc = prepare(torch.tensor(cost), torch.tensor(row_mask), torch.tensor(col_mask))[0]
    row2col, steps = solve_n_le_m_cuda(pc.cuda())
    want_r2c, want_steps = solve_n_le_m_plain_steps(pc)
    np.testing.assert_array_equal(row2col.cpu().numpy(), want_r2c.numpy())
    np.testing.assert_array_equal(steps.cpu().numpy(), want_steps.numpy())


@pytest.mark.parametrize("kind", ["normal", "ties", "padded", "nan_entry"])
@pytest.mark.parametrize("B, n, m", [(4, 64, 100), (4, 100, 100), (4, 100, 64), (3, 7, 7),
                                     (5, 1, 9), (2, 9, 1), (3, 1, 1), (3, 20, 32), (3, 20, 33),
                                     (2, 40, 128), (2, 40, 129), (2, 200, 256), (1, 256, 256)])
def test_hungarian_kernel_matches_plain(kind, B, n, m):
    """The kernel's assignments and search steps equal the plain loop's bit
    for bit: the train step's batch (4 x 64 x 100 and 100 x 100, and 100 x
    64 as the mask matcher hands it), square, n < m and n > m, m on both
    sides of every slot count a lane takes (1, 32 / 33, 128 / 129, 256),
    n = m = 256 (the costs too large for shared memory, read from global),
    integer costs with ties, padded rows and columns, and a single NaN
    entry."""
    case = _hungarian_case(kind, B, n, m, seed=B * n + m)
    got, want, n_launch = _hungarian_on_card(*case)
    assert n_launch == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _steps_match_plain(*case)


def test_hungarian_kernel_padded_triplet_batch():
    """PSGTr's HTriMatcher shape: 6 layers x 2 images of 100 queries against
    100 GT triplet slots, 3 and 5 of them valid, the rest PAD_COST
    columns: the longest searches a 100-row problem takes (5,050 steps at
    most). Assignments and search steps as the plain loop's."""
    rng = np.random.default_rng(12)
    cost = (5 * rng.normal(size=(12, 100, 100))).astype(np.float32)
    col_mask = np.arange(100)[None] < np.array([3, 5] * 6)[:, None]
    row_mask = np.ones((12, 100), bool)
    got, want, n_launch = _hungarian_on_card(cost, row_mask, col_mask)
    assert n_launch == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _steps_match_plain(cost, row_mask, col_mask)


def test_hungarian_kernel_nan_row_terminates():
    """A whole row of NaN costs has no reference answer (the JAX solver does
    not return): the kernel returns with the plain loop's assignments and
    search steps (a degenerate search: the plain walk, then per-row
    potentials for the rows after it)."""
    cost = np.asarray([[[1.0, 2.0, 3.0], [np.nan] * 3, [3.0, 1.0, 2.0]]], np.float32)
    cost = np.concatenate([cost, np.random.default_rng(0).normal(size=(3, 3, 3))]).astype(
        np.float32)
    cost[2, 0] = np.nan
    c, = _on_card(cost)
    row2col, steps = solve_n_le_m_cuda(c)
    torch.cuda.synchronize()
    want_r2c, want_steps = solve_n_le_m_plain_steps(torch.tensor(cost))
    print("all-NaN row: kernel row2col", row2col.cpu().tolist(), "steps", steps.cpu().tolist(),
          "plain", want_r2c.tolist(), want_steps.tolist())
    assert row2col.shape == (4, 3) and int(steps.max()) <= 3 * 4
    np.testing.assert_array_equal(row2col.cpu().numpy(), want_r2c.numpy())
    np.testing.assert_array_equal(steps.cpu().numpy(), want_steps.numpy())


@pytest.mark.parametrize("kind", ["normal", "ties", "padded", "nan_entry"])
@pytest.mark.parametrize("B, n, m", [(2, 6, 300), (2, 4, 1000), (3, 300, 6), (2, 64, 22323),
                                     (1, 100, 37485), (1, 8, MAX_COLS), (2, 9, 257),
                                     (2, 100, 4099)])
def test_hungarian_long_instance_matches_plain(kind, B, n, m):
    """Above SHORT_COLS columns the long instance solves (one launch of it),
    equal to the plain loop bit for bit: tall problems as given and after
    the n > m transpose, the detection-only loss's encoder matcher (64 GT
    boxes against the 22,323 proposals at 800x1344; 100 against 37,485 at
    1344x1344), the instance's limit, its smallest problem (m = 257: a
    column or two in the cluster's last CTA) and m a multiple of neither 8
    nor 16 (4,099)."""
    long_before = batched_hungarian.long_launches
    got, want, n_launch = _hungarian_on_card(*_hungarian_case(kind, B, n, m, seed=B * n + m))
    assert n_launch == 1 and batched_hungarian.long_launches == long_before + 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_hungarian_long_instance_clusters():
    """The long instance runs a cluster of at least 2 CTAs a problem at its
    smallest m, at the encoder matcher's and at its limit."""
    from pairnet_torch.ops.hungarian import long_cluster

    _on_card(np.zeros(1, np.float32))
    sizes = {m: long_cluster(m) for m in (SHORT_COLS + 1, 22323, MAX_COLS)}
    print("cluster sizes", sizes)
    assert all(k >= 2 for k in sizes.values())


def test_hungarian_long_instance_nan_row_terminates():
    """A whole row of NaN costs in a long problem (a degenerate search: its
    way is never set, the plain walk runs through distributed shared
    memory): the kernel returns with the plain loop's assignments and
    search steps."""
    from pairnet_torch.ops.hungarian import solve_n_le_m_plain

    cost = np.random.default_rng(5).normal(size=(2, 5, 300)).astype(np.float32)
    cost[0, 2] = np.nan
    c, = _on_card(cost)
    row2col, steps = solve_n_le_m_cuda(c)
    torch.cuda.synchronize()
    for b in range(2):
        syncs = batched_hungarian.syncs
        want = solve_n_le_m_plain(torch.tensor(cost[b:b + 1]))[0]
        print("problem", b, "kernel", row2col[b].tolist(), int(steps[b]), "plain", want.tolist())
        np.testing.assert_array_equal(row2col[b].cpu().numpy(), want.numpy())
        assert int(steps[b]) == batched_hungarian.syncs - syncs


def test_hungarian_kernel_raises_above_its_limit():
    """More than MAX_COLS columns (as given, or after the n > m transpose)
    raises and launches nothing; so does n > m given to the kernel itself."""
    cost, = _on_card(np.zeros((1, 3, MAX_COLS + 1), np.float32))
    launches = batched_hungarian.launches
    with pytest.raises(ValueError, match=f"n <= m <= {MAX_COLS}"):
        batched_hungarian(cost)
    with pytest.raises(ValueError, match=f"n <= m <= {MAX_COLS}"):
        batched_hungarian(cost.transpose(1, 2))
    with pytest.raises(ValueError, match=f"n <= m <= {MAX_COLS}"):
        solve_n_le_m_cuda(cost[:, :, :2])
    assert batched_hungarian.launches == launches
    assert SHORT_COLS == 256


def test_hungarian_kernel_calls_in_a_row_on_one_stream():
    """Five calls queued on one stream with no sync between them, the
    step's two shapes alternating: each result equals the plain loop's."""
    cases = [_hungarian_case("normal", 4, n, m, seed=s)
             for s, (n, m) in enumerate([(100, 64), (100, 100)] * 2 + [(100, 64)])]
    on_card = [_on_card(*case) for case in cases]
    launches, syncs = batched_hungarian.launches, batched_hungarian.syncs
    results = [batched_hungarian(*args) for args in on_card]
    torch.cuda.synchronize()
    assert batched_hungarian.launches - launches == 5
    assert batched_hungarian.syncs == syncs
    for (cost, rm, cm), got in zip(cases, results):
        want = batched_hungarian_plain(torch.tensor(cost), torch.tensor(rm), torch.tensor(cm))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def nms_boxes(seed, B, n, spread=800.0, ties=True):
    """(B, n, 4) boxes, scores and valid for the NMS kernel: anchors-like
    boxes with planted score ties, pairs at IoU exactly 0.5 and 0.7 (exact
    in f32) and a tenth invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (B, n, 2))
    wh = rng.uniform(8, spread / 4, (B, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    for i in range(0, n - 2, 9):  # a 10 x 10 box, its 10 x 5 half (0.5), its 10 x 7 (0.7)
        x, y = np.floor(xy[:, i]).T.astype(np.float32)
        boxes[:, i] = np.stack([x, y, x + 10, y + 10], -1)
        boxes[:, i + 1] = np.stack([x, y, x + 10, y + 5], -1)
        boxes[:, i + 2] = np.stack([x, y, x + 10, y + 7], -1)
    scores = rng.random((B, n)).astype(np.float32)
    if ties:
        scores[:, 2::3] = scores[:, 1::3][:, : scores[:, 2::3].shape[1]]
    valid = rng.random((B, n)) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("B, n, thr", [(2, 4819, 0.7), (2, 256, 0.5), (3, 1, 0.5),
                                       (1, 1000, 0.7), (1, 12288, 0.5), (2, 63, 0.5),
                                       (2, 64, 0.7), (2, 65, 0.5), (2, 4097, 0.7)],
                         ids=["rpn", "detections", "one_box", "thr_0.7_ties", "largest",
                              "63", "64", "65", "4097"])
def test_nms_kernel_matches_plain(B, n, thr):
    """``csrc/nms.cu`` against the plain sweep: equal keep masks at the RPN's
    and the detections' geometries, ties, IoU exactly at the threshold,
    invalid entries, the largest N the kernel holds, N either side of a
    64-box block and one box past 64 blocks (4,097)."""
    boxes, scores, valid = _on_card(*nms_boxes(n, B, n))
    launches = nms.nms_sorted.launches
    got = nms.nms(boxes, scores, thr, valid)
    torch.cuda.synchronize()
    assert nms.nms_sorted.launches == launches + 1
    want = nms.nms(boxes.cpu(), scores.cpu(), thr, valid.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_nms_kernel_suppression_chain():
    """4,097 boxes in a row, each overlapping the next (IoU 1/3 > 0.3) and
    no other: every block's diagonal takes the most rounds, and the keep
    mask is the plain sweep's, every other box."""
    x = np.arange(4097, dtype=np.float32) * 5
    boxes = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], -1)[None]
    b, v = _on_card(np.repeat(boxes, 2, 0), np.ones((2, 4097), bool))
    got = nms.nms_sorted_cuda(b, v, 0.3)
    torch.cuda.synchronize()
    want = nms.nms_sorted_plain(b.cpu(), v.cpu(), 0.3)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert bool(want[0, ::2].all()) and not bool(want[0, 1::2].any())


def test_nms_kernel_parts_launched_apart():
    """The mask kernel and the sweep called one by one (as they are timed)
    keep what one call keeps, and count no launch."""
    boxes, scores, valid = nms_boxes(3, 2, 4819)
    order = nms.score_order(*_on_card(scores, valid))
    b, v = _on_card(boxes, valid)
    b = torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    v = torch.gather(v, 1, order).contiguous()
    want = nms.nms_sorted_cuda(b, v, 0.7)
    launches = nms.nms_sorted.launches
    mask, sweep, keep = nms.nms_sorted_parts(b, v, 0.7)
    mask()
    sweep()
    torch.cuda.synchronize()
    assert nms.nms_sorted.launches == launches
    assert torch.equal(keep, want)


def test_nms_kernel_class_offset_and_limit():
    """The detections' class-offset NMS on the card equals the plain one;
    more boxes than the kernel holds raise and launch nothing."""
    boxes, scores, valid = nms_boxes(1, 2, 256)
    labels = np.random.default_rng(2).integers(0, 80, (2, 256)).astype(np.int32)
    args = _on_card(boxes, scores, labels, valid)
    got = nms.batched_nms(args[0], args[1], args[2], 0.5, args[3])
    want = nms.batched_nms(*(torch.tensor(a) for a in (boxes, scores, labels)), 0.5,
                           torch.tensor(valid))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    big, = _on_card(np.zeros((1, 12289, 4), np.float32))
    launches = nms.nms_sorted.launches
    with pytest.raises(ValueError, match="holds at most 12288"):
        nms.nms_sorted(big, torch.ones((1, 12289), dtype=torch.bool, device="cuda"), 0.5)
    assert nms.nms_sorted.launches == launches
