"""Port parity: the masked flash cross-attention of ``pairnet_torch`` (its
plain version, which CPU tensors take) against the JAX package's Pallas
kernel in interpret mode, and the flash route of ``MultiheadAttention``.

The CUDA kernel is held against the plain version on the GPU by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``; here a plain
emulation of its arithmetic (tensor-core operand splits, key chunks and
their merge) is held against the plain version on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from pairnet_tpu.models.layers import MultiheadAttention as JMHA
from pairnet_tpu.ops.pallas_masked_attn import ST, masked_flash_attention as j_flash
from test_torch_helpers import nest, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.flagship import set_flash_attention  # noqa: E402
from pairnet_torch.models import layers  # noqa: E402
from pairnet_torch.ops.deform_attn import bf16_ulps_off  # noqa: E402
from pairnet_torch.ops.masked_attn import (  # noqa: E402
    chunk_keys,
    masked_flash_attention,
    masked_flash_attention_plain,
)
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


TOL_FLASH = 1e-4  # chip_smoke.py's: max |kernel - plain| / max(1, max |plain|)


def _bf16(x):
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x, rnd):
    """x = hi + lo, both in the rounding ``rnd``."""
    hi = rnd(x)
    return hi, rnd((x - hi).astype(np.float32))


def _mm(a, b):  # an f32 accumulator of exact products
    return np.matmul(a.astype(np.float64), b.astype(np.float64)).astype(np.float32)


def _flash_emulation(q, k, v, mask, H, bf16, ck):
    """The CUDA kernel's arithmetic in numpy on f32 q, k, v (bf16 values
    when ``bf16``): bf16 -- exact q.k products, the 1/sqrt(D) scale after
    them, P split into bf16 hi and lo parts for P.V; f32 -- q scaled first,
    3xTF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi). Softmax partials
    per chunk of ``ck`` keys, merged as the merge kernel does. Returns the
    output and each chunk's merge weight (BH, Lq, chunks)."""
    BH, Lq, D = q.shape
    scale = np.float32(1.0 / np.sqrt(D))
    kt = k.transpose(0, 2, 1)
    if bf16:
        s = _mm(q, kt) * scale
    else:
        (qh, ql), (kh, kl) = _split(q * scale, _tf32), _split(kt, _tf32)
        s = _mm(ql, kh) + _mm(qh, kl) + _mm(qh, kh)
    s = s.reshape(-1, H, Lq, s.shape[-1])
    s = np.where(mask[:, None], np.float32(-1e9), s).reshape(BH, Lq, -1)
    ms, ls, accs = [], [], []
    for c0 in range(0, s.shape[-1], ck):
        sc, vc = s[..., c0 : c0 + ck], v[:, c0 : c0 + ck]
        m = sc.max(axis=-1, keepdims=True)
        p = np.exp(sc - m).astype(np.float32)
        if bf16:
            ph, pl = _split(p, _bf16)
            acc = _mm(pl, vc) + _mm(ph, vc)
        else:
            (ph, pl), (vh, vl) = _split(p, _tf32), _split(vc, _tf32)
            acc = _mm(pl, vh) + _mm(ph, vl) + _mm(ph, vh)
        ms.append(m)
        ls.append(p.sum(axis=-1, keepdims=True))
        accs.append(acc)
    m = np.max(ms, axis=0)
    w = [np.exp(mc - m) for mc in ms]
    l = sum(wc * lc for wc, lc in zip(w, ls))
    out = sum(wc * ac for wc, ac in zip(w, accs)) / np.maximum(l, 1e-30)
    return out, np.concatenate(w, axis=-1)


@pytest.mark.parametrize("amp", [1.0, 5.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_numerics_emulated(dtype, amp):
    """The CUDA kernel's numerics, emulated on the CPU, against the plain
    version at the decoder's geometry (H = 8, Lq = 100, D = 32) over 3000
    keys in the chunks the kernel would take on a 132-SM card: N(0, 1) x amp
    inputs, a mask about half set, a row masked everywhere (it averages all
    values), the second key chunk masked in every row (its merge weight is
    exactly 0 beside a live key). Within chip_smoke.py's TOL_FLASH."""
    rng = np.random.default_rng(int(amp) + len(dtype))
    B, H, Lq, Lk, D = 2, 8, 100, 3000, 32
    ck = chunk_keys(B, Lk, 132)
    q, k, v = (amp * rng.normal(size=(B * H, n, D)).astype(np.float32) for n in (Lq, Lk, Lk))
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    mask = rng.uniform(size=(B, Lq, Lk)) < 0.5
    mask[:, :, ck : 2 * ck] = True
    mask[:, np.arange(Lq), rng.integers(2 * ck, Lk, Lq)] = False
    mask[:, 7] = True
    out, w = _flash_emulation(q, k, v, mask, H, dtype == "bfloat16", ck)
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    ref = masked_flash_attention_plain(tq, tk, tv, torch.tensor(mask), H).numpy()
    err = float(np.abs(out - ref).max())
    assert err <= TOL_FLASH * max(1.0, float(np.abs(ref).max())), err
    live = np.ones(Lq, bool)
    live[7] = False
    assert np.all(w[:, live, 1] == 0) and np.all(w[:, 7] == 1)
