"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them.
On a GPU machine: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
"""

import numpy as np
import pytest

from test_torch_helpers import msda_inputs

torch = pytest.importorskip("torch")

from pairnet_torch.ops.deform_attn import ms_deform_attn_plain  # noqa: E402
from pairnet_torch.ops.deform_attn_exact import deform_attn_exact  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import (  # noqa: E402
    bf16_ulps_off,
    int4_gather,
    int4_gather_plain,
    int4_quantize,
    int4_quantize_plain,
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
