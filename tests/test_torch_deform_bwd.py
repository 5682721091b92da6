"""Port parity: the MSDA backward of ``pairnet_torch`` against the JAX
package's Pallas backward kernels, run in interpret mode on the CPU.

* the plain backward (``ms_deform_attn_bwd_plain``) against
  ``_ms_deform_attn_bwd2_impl`` (the default VJP), tight and wild offsets;
* its ``bf16_grad`` variant against ``_ms_deform_attn_bwd3_impl`` on
  bf16-representable values and upstream grads;
* the autograd Functions of the exact and the int4 forward, whose CPU
  backward is the plain version: the same gradients, in the input dtypes;
* the plain backward against bwd2 again on the inputs of the GPU tests'
  edge cases (``tests/test_torch_cuda_kernels.py``): every tap in one pixel
  cell (hot spot), and taps on the plane's border and wholly off it, whose
  gradients are exactly 0;
* the wrappers' shared argument helpers.

Tolerances are those of the JAX package's own tests
(``tests/test_deform_bwd2.py``, ``tests/test_deform_bwd3.py``): 2e-5 x
max|ref| per output (f32 reassociation), 1e-2 x max|ref| for the bf16_grad
dvalue (bwd3 rounds each per-tap product to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from pairnet_tpu.ops.pallas_deform_bwd2 import _ms_deform_attn_bwd2_impl
from pairnet_tpu.ops.pallas_deform_bwd3 import _ms_deform_attn_bwd3_impl
from test_torch_helpers import msda_border_inputs, msda_hotspot_inputs, msda_inputs
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.ops.deform_attn import aligned, check_width  # noqa: E402
from pairnet_torch.ops.deform_attn_bwd import ms_deform_attn_bwd_plain  # noqa: E402
from pairnet_torch.ops.deform_attn_exact import ms_deform_attn_exact  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import ms_deform_attn_int4  # noqa: E402

NAMES = ("dvalue", "dlocs", "dweights")
TOL = {"dvalue": 2e-5, "dlocs": 2e-5, "dweights": 2e-5}
TOL_BF16_GRAD = {"dvalue": 1e-2, "dlocs": 2e-5, "dweights": 2e-5}
Q = 200  # two query tiles of the Pallas kernels, the second padded
Q_EDGE = 64  # the edge cases: one padded tile


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=[False, True], ids=["tight", "wild"])
def bwd2_case(request):
    """(inputs, JAX bwd2 gradients) for f32 values."""
    shapes, value, locs, w = msda_inputs(seed=2, wild=request.param, Q=Q)
    g = np.random.default_rng(12).normal(size=(*locs.shape[:2], 4 * 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _ms_deform_attn_bwd2_impl(jnp.asarray(value), shapes, jnp.asarray(locs),
                                        jnp.asarray(w), jnp.asarray(g))
    return (shapes, value, locs, w, g), [np.asarray(r) for r in ref]


@pytest.fixture(scope="module")
def bwd3_case():
    """(inputs, JAX bwd3 gradients) for bf16-representable values and
    upstream grads, wild offsets."""
    shapes, value, locs, w = msda_inputs(seed=3, wild=True, Q=Q)
    g = np.random.default_rng(13).normal(size=(*locs.shape[:2], 4 * 32)).astype(np.float32)
    value, g = _bf16(value), _bf16(g)
    with pltpu.force_tpu_interpret_mode():
        ref = _ms_deform_attn_bwd3_impl(jnp.asarray(value), shapes, jnp.asarray(locs),
                                        jnp.asarray(w), jnp.asarray(g))
    return (shapes, value, locs, w, g), [np.asarray(r) for r in ref]


def _check(got, ref, tol):
    for name, a, b in zip(NAMES, ref, got):
        b = b.float().numpy()
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b, a, atol=tol[name] * np.abs(a).max(), rtol=0, err_msg=name)


def test_plain_bwd_matches_jax_bwd2(bwd2_case):
    (shapes, value, locs, w, g), ref = bwd2_case
    got = ms_deform_attn_bwd_plain(torch.tensor(value), shapes, torch.tensor(locs),
                                   torch.tensor(w), torch.tensor(g))
    _check(got, ref, TOL)


def test_bf16_grad_plain_bwd_matches_jax_bwd3(bwd3_case):
    (shapes, value, locs, w, g), ref = bwd3_case
    got = ms_deform_attn_bwd_plain(torch.tensor(value), shapes, torch.tensor(locs),
                                   torch.tensor(w), torch.tensor(g), bf16_grad=True)
    _check(got, ref, TOL_BF16_GRAD)


def _function_grads(fn, value, shapes, locs, w, g, bwd):
    leaves = [value.requires_grad_(), torch.tensor(locs, requires_grad=True),
              torch.tensor(w, requires_grad=True)]
    out = fn(leaves[0], shapes, leaves[1], leaves[2], bwd)
    out.backward(torch.tensor(g).to(out.dtype))
    return out, [t.grad for t in leaves]


def test_exact_function_backward_matches_jax_bwd2(bwd2_case):
    """The exact forward's Function saves (value, locs, weights) and its
    backward gives bwd2's gradients, in the inputs' dtypes."""
    (shapes, value, locs, w, g), ref = bwd2_case
    out, grads = _function_grads(ms_deform_attn_exact, torch.tensor(value), shapes, locs, w, g,
                                 "exact")
    assert out.dtype == torch.float32 and out.grad_fn is not None
    assert [t.dtype for t in grads] == [torch.float32] * 3
    _check(grads, ref, TOL)


def test_int4_function_backward_matches_jax_bwd3(bwd3_case):
    """The int4 forward's Function differentiates on the saved bf16 value,
    not its codes (``pallas_deform_attn_v16.py:343-352``); with the
    bf16_grad backward it gives bwd3's gradients, dvalue in bf16."""
    (shapes, value, locs, w, g), ref = bwd3_case
    out, grads = _function_grads(ms_deform_attn_int4, torch.tensor(value).to(torch.bfloat16),
                                 shapes, locs, w, g, "bf16_grad")
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32, torch.float32]
    _check(grads, ref, TOL_BF16_GRAD)


@pytest.fixture(scope="module", params=["hot_spot", "border"])
def edge_case(request):
    """(inputs, off-plane tap mask, JAX bwd2 gradients) on the GPU tests'
    edge inputs, f32 values."""
    if request.param == "hot_spot":
        shapes, value, locs, w = msda_hotspot_inputs(seed=4, Q=Q_EDGE)
        off = np.zeros(w.shape, bool)
    else:
        shapes, value, locs, w, off = msda_border_inputs(seed=5, Q=Q_EDGE)
    g = np.random.default_rng(14).normal(size=(*locs.shape[:2], 4 * 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _ms_deform_attn_bwd2_impl(jnp.asarray(value), shapes, jnp.asarray(locs),
                                        jnp.asarray(w), jnp.asarray(g))
    return (shapes, value, locs, w, g), off, [np.asarray(r) for r in ref]


def test_plain_bwd_matches_jax_bwd2_on_edge_inputs(edge_case):
    """The plain backward, which the GPU tests hold the kernel against, is
    bwd2's on the hot-spot and border inputs; a tap with no corner in the
    plane gets dlocs and dweights exactly 0 from both."""
    (shapes, value, locs, w, g), off, ref = edge_case
    got = ms_deform_attn_bwd_plain(torch.tensor(value), shapes, torch.tensor(locs),
                                   torch.tensor(w), torch.tensor(g))
    _check(got, ref, TOL)
    for r, k in ((ref[1], got[1]), (ref[2], got[2])):
        assert not np.asarray(r)[off].any() and not k.numpy()[off].any()


def test_border_inputs_cover_the_edges():
    """The border inputs hold taps with x0 = -1, x0 = w - 1, on integer
    pixels and wholly off the plane, and in-plane taps beside them."""
    shapes, _, locs, _, off = msda_border_inputs(seed=5, Q=Q_EDGE)
    assert 0.1 < off.mean() < 0.9
    for lvl, (h, w) in enumerate(shapes):
        px = locs[..., lvl, :, 0] * w - 0.5
        x0 = np.floor(px)
        assert (x0 == -1).any() and (x0 == w - 1).any() and (px == np.round(px)).any()
    _, _, _, _, all_off = msda_border_inputs(seed=9, all_off=True)
    assert all_off.all()


@pytest.mark.parametrize("D", [8, 16, 24, 32, 64])
def test_check_width_takes_multiples_of_8_up_to_64(D):
    check_width(D, "kernel")


@pytest.mark.parametrize("D", [0, 4, 12, 72, 128])
def test_check_width_raises_beyond(D):
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        check_width(D, "kernel")


def test_aligned_makes_views_contiguous_and_aligned():
    base = torch.arange(40, dtype=torch.float32)
    view = base[1:33].reshape(4, 8)
    strided = base[:32].reshape(8, 4).t()
    for t, out in zip((view, strided), aligned(view, strided)):
        assert out.is_contiguous() and out.data_ptr() % 16 == 0 and torch.equal(out, t)
    fresh = torch.zeros(16)
    assert aligned(fresh)[0] is fresh
