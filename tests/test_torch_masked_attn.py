"""Port parity: the masked flash cross-attention of ``pairnet_torch`` (its
plain version, which CPU tensors take) against the JAX package's Pallas
kernel in interpret mode, and the flash route of ``MultiheadAttention``.

The CUDA kernel is held against the plain version on the GPU by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from pairnet_tpu.models.layers import MultiheadAttention as JMHA
from pairnet_tpu.ops.pallas_masked_attn import ST, masked_flash_attention as j_flash
from test_torch_helpers import nest, perturb

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import set_flash_attention  # noqa: E402
from pairnet_torch.models import layers  # noqa: E402
from pairnet_torch.ops.deform_attn import bf16_ulps_off  # noqa: E402
from pairnet_torch.ops.masked_attn import masked_flash_attention  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

C, HEADS = 32, 4
PREFIX = "bbox_head.transformer_decoder.layers.0.attentions.0.attn."
FLAX_PATH = ("bbox_head", "transformer_decoder", "layer_0", "cross_attn")


@pytest.mark.parametrize("B, H, Lq, Lk, D, all_masked_row", [
    (2, 4, 104, 2 * ST, 32, True),  # tests/test_masked_flash_attn.py's first case
    (2, 2, 8, ST, 16, False),  # its head-shared case
])
def test_plain_matches_pallas_interpret(B, H, Lq, Lk, D, all_masked_row):
    """f32 inputs, the mask shared by the heads of an image; a row masked
    everywhere averages all values in both. atol 1e-5: the Pallas kernel's
    online softmax over 1024-key tiles against one softmax."""
    rng = np.random.default_rng(Lq)
    q, k, v = (rng.normal(size=(B * H, n, D)).astype(np.float32) for n in (Lq, Lk, Lk))
    mask = rng.uniform(size=(B, Lq, Lk)) < 0.6
    mask[0, :, : Lk // 2] = True
    if all_masked_row:
        mask[:, 7] = True
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(mask, jnp.int8), H))
    out = masked_flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 torch.tensor(mask), H)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def _mha_case(seed, Lk, dtype):
    """JAX MHA variables, queries, memory and a head-shared mask about half
    set with a live key in every row. In bf16 the projections are 2 x the
    identity, so q, k and v are exact in both packages."""
    rng = np.random.default_rng(seed)
    B, Lq = 2, 20
    q = rng.normal(size=(B, Lq, C)).astype(np.float32)
    kv = rng.normal(size=(B, Lk, C)).astype(np.float32)
    mask = rng.uniform(size=(B, 1, Lq, Lk)) < 0.5
    mask[:, 0, np.arange(Lq), rng.integers(0, Lk, Lq)] = False
    jm = JMHA(C, HEADS)
    v = perturb(jm.init(jax.random.PRNGKey(seed), q[:, :2], kv[:, :2], kv[:, :2]), seed)
    if dtype == "bfloat16":
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            v["params"][name]["kernel"] = 2 * np.eye(C, dtype=np.float32)
        q, kv = (a.astype(jnp.bfloat16).astype(np.float32) for a in (q, kv))
    return jm, v, q, kv, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_flash_route_matches_jax(monkeypatch, dtype):
    """The port's MultiheadAttention with flash on against JAX's with
    PAIRNET_FLASH_ATTN=1 (Pallas kernel in interpret mode) at Lk = 2048:
    f32 within 1e-5; bf16 within one bf16 ulp (the f32 flash outputs agree
    to ~1e-6, then each package rounds them to bf16 before out_proj)."""
    jm, v, q, kv, mask = _mha_case(1, 2048, dtype)
    jdt = getattr(jnp, dtype)
    monkeypatch.setenv("PAIRNET_FLASH_ATTN", "1")
    with pltpu.force_tpu_interpret_mode():
        ref = jm.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v),
                       *(jnp.asarray(a, jdt) for a in (q, kv, kv)), attn_mask=mask)
    ref = torch.tensor(np.asarray(ref.astype(jnp.float32)))
    tree = {col: nest(x, *FLAX_PATH) for col, x in v.items()}
    port = load_jax_variables(layers.MultiheadAttention(C, HEADS).eval(), tree, PREFIX)
    set_flash_attention(port, True)
    tdt = getattr(torch, dtype)
    calls = []
    monkeypatch.setattr(layers, "masked_flash_attention",
                        lambda *a: calls.append(a[0].shape) or masked_flash_attention(*a))
    with torch.no_grad():
        out = port.to(tdt)(*(torch.tensor(a).to(tdt) for a in (q, kv, kv)),
                           attn_mask=torch.tensor(mask))
    assert calls == [(2 * HEADS, 20, C // HEADS)] and out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    else:
        assert bf16_ulps_off(out, ref) == 0


@pytest.mark.parametrize("Lk, per_head, flash, route", [
    (2047, False, True, "matmul"),
    (2048, True, True, "matmul"),
    (2048, False, False, "matmul"),
    (2048, False, True, "flash"),
])
def test_flash_route_conditions(monkeypatch, Lk, per_head, flash, route):
    """Flash only with the route on, a head-shared mask and Lk >= 2048, as
    JAX's conditions (layers.py:103-109); the matmul route otherwise. The
    two routes give the same function (f32, atol 1e-5)."""
    _, v, q, kv, mask = _mha_case(2, Lk, "float32")
    if per_head:
        mask = np.repeat(mask, HEADS, axis=1)
    tree = {col: nest(x, *FLAX_PATH) for col, x in v.items()}
    port = load_jax_variables(layers.MultiheadAttention(C, HEADS).eval(), tree, PREFIX)
    calls = []
    monkeypatch.setattr(layers, "masked_flash_attention",
                        lambda *a: calls.append(1) or masked_flash_attention(*a))
    args = [torch.tensor(a) for a in (q, kv, kv)]
    with torch.no_grad():
        set_flash_attention(port, flash)
        out = port(*args, attn_mask=torch.tensor(mask))
        set_flash_attention(port, False)
        want = port(*args, attn_mask=torch.tensor(mask))
    assert calls == ([1] if route == "flash" else [])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=0)
