"""Port parity: layers, backbone and pixel decoder of ``pairnet_torch``
against the JAX package, through the weight bridge (f32, CPU)."""

import jax
import numpy as np
import pytest

from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
from pairnet_tpu.models.heads.matrix_learner import ConvTiny as JConvTiny
from pairnet_tpu.models.layers import MSDeformAttention as JMSDA
from pairnet_tpu.models.layers import MultiheadAttention as JMHA
from pairnet_tpu.models.layers import encoder_reference_points as j_ref_points
from pairnet_tpu.models.layers import sine_positional_encoding as j_sine
from pairnet_tpu.models.necks.pixel_decoder import DeformableEncoderLayer as JEncLayer
from pairnet_tpu.models.necks.pixel_decoder import MSDeformAttnPixelDecoder as JPixelDecoder
from test_torch_helpers import nest, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.heads.matrix_learner import ConvTiny  # noqa: E402
from pairnet_torch.models.layers import (  # noqa: E402
    MSDeformAttention,
    MultiheadAttention,
    encoder_reference_points,
    sine_positional_encoding,
)
from pairnet_torch.models.necks.pixel_decoder import (  # noqa: E402
    DeformableEncoderLayer,
    MSDeformAttnPixelDecoder,
)
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

SHAPES = ((3, 5), (6, 10), (12, 20))  # landscape, low -> high resolution
C, HEADS = 32, 4


def _bridge(port, jvars, prefix, *flax_path):
    """Load ``jvars`` (rooted at the flax module) into ``port``, a submodule
    found at ``prefix`` inside a full Pair-Net."""
    tree = {col: nest(v, *flax_path) for col, v in jvars.items()}
    return load_jax_variables(port.eval(), tree, prefix)


def _init(module, seed, *args, **kwargs):
    return perturb(module.init(jax.random.PRNGKey(seed), *args, **kwargs), seed)


def test_sine_positional_encoding_and_reference_points():
    np.testing.assert_allclose(
        sine_positional_encoding(7, 11, 16).numpy(), np.asarray(j_sine(7, 11, 16)), atol=1e-5
    )
    np.testing.assert_allclose(
        encoder_reference_points(SHAPES).numpy(), np.asarray(j_ref_points(SHAPES)), atol=0
    )


def test_multihead_attention_with_mask():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 7, C)).astype(np.float32)
    kv = rng.normal(size=(2, 13, C)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 7, 13)) > 0.6  # True = not attended
    mask[:, :, 0] = True  # a row masked everywhere: uniform over the -1e9 fills
    jm = JMHA(C, HEADS)
    v = _init(jm, 0, q, kv, kv, attn_mask=mask)
    ref = jm.apply(v, q, kv, kv, attn_mask=mask)
    port = _bridge(MultiheadAttention(C, HEADS), v,
                   "bbox_head.transformer_decoder.layers.0.attentions.0.attn.",
                   "bbox_head", "transformer_decoder", "layer_0", "cross_attn")
    with torch.no_grad():
        out = port(torch.tensor(q), torch.tensor(kv), torch.tensor(kv),
                   attn_mask=torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bf16_attention_logits_stay_f32():
    """In bf16, q . k^T is summed and kept in f32 (JAX's
    preferred_element_type=f32): with logits near 100, a bf16 rounding of
    them (an ulp of 0.5) would move the softmax by far more than the
    tolerance. Identity projections keep q, k and v exact in bf16, so the
    two packages differ only in the f32 sum order of the logits."""
    bf16 = jax.numpy.bfloat16
    rng = np.random.default_rng(6)
    q = (rng.normal(size=(2, 7, C)) * 3).astype(bf16)
    kv = (rng.normal(size=(2, 13, C)) * 3).astype(bf16)
    jm = JMHA(C, HEADS)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), q, kv, kv))
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        v["params"][name]["kernel"] = 2 * np.eye(C, dtype=np.float32)
    ref = np.asarray(jm.apply(jax.tree_util.tree_map(lambda a: a.astype(bf16), v), q, kv, kv),
                     np.float32)
    port = _bridge(MultiheadAttention(C, HEADS), v,
                   "bbox_head.transformer_decoder.layers.0.attentions.0.attn.",
                   "bbox_head", "transformer_decoder", "layer_0", "cross_attn").to(torch.bfloat16)
    with torch.no_grad():
        out = port(*(torch.tensor(a.astype(np.float32)).to(torch.bfloat16) for a in (q, kv, kv)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


def _tokens(seed, B=2):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    pos = rng.normal(size=(B, S, C)).astype(np.float32)
    ref = np.broadcast_to(np.asarray(j_ref_points(SHAPES))[None], (B, S, len(SHAPES), 2))
    return x, pos, np.ascontiguousarray(ref)


def test_ms_deform_attention():
    x, pos, ref = _tokens(1)
    jm = JMSDA(C, HEADS, 3, 4, impl="rows")
    v = _init(jm, 1, x, x, ref, SHAPES, query_pos=pos)
    expected = jm.apply(v, x, x, ref, SHAPES, query_pos=pos)
    port = _bridge(MSDeformAttention(C, HEADS, 3, 4), v,
                   "bbox_head.pixel_decoder.encoder.layers.0.attentions.0.",
                   "bbox_head", "pixel_decoder", "encoder_layer_0", "attn")
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(x), torch.tensor(ref), SHAPES,
                   query_pos=torch.tensor(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-5, rtol=0)


def test_deformable_encoder_layer():
    x, pos, ref = _tokens(2)
    jm = JEncLayer(C, HEADS, 3, 4, 64)
    v = _init(jm, 2, x, pos, ref, SHAPES)
    expected = jm.apply(v, x, pos, ref, SHAPES)
    port = _bridge(DeformableEncoderLayer(C, HEADS, 3, 4, 64), v,
                   "bbox_head.pixel_decoder.encoder.layers.0.",
                   "bbox_head", "pixel_decoder", "encoder_layer_0")
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(pos), torch.tensor(ref), SHAPES)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-5, rtol=0)


def test_resnet_backbone_landscape():
    img = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = JResNet(depth=26, base_width=8)
    v = _init(jm, 3, img)
    expected = jm.apply(v, img)
    port = _bridge(ResNet(depth=26, base_width=8), v, "backbone.", "backbone")
    with torch.no_grad():
        outs = port(torch.tensor(img).permute(0, 3, 1, 2))
    for o, e in zip(outs, expected):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


def test_pixel_decoder_landscape():
    """The JAX decoder runs landscape inputs on transposed planes; the
    row-major port must agree."""
    rng = np.random.default_rng(4)
    chans = (16, 24, 40, 48)
    sizes = ((24, 40), (12, 20), (6, 10), (3, 5))
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32) for (h, w), c in zip(sizes, chans)]
    jm = JPixelDecoder(feat_channels=C, out_channels=C, num_encoder_layers=2, num_heads=HEADS,
                       feedforward_channels=64)
    v = _init(jm, 4, feats)
    exp_mask, exp_ms = jm.apply(v, feats)
    port = _bridge(
        MSDeformAttnPixelDecoder(chans, C, C, num_encoder_layers=2, num_heads=HEADS,
                                 feedforward_channels=64),
        v, "bbox_head.pixel_decoder.", "bbox_head", "pixel_decoder",
    )
    with torch.no_grad():
        mask, ms = port([torch.tensor(f).permute(0, 3, 1, 2) for f in feats])
    np.testing.assert_allclose(mask.permute(0, 2, 3, 1).numpy(), np.asarray(exp_mask),
                               atol=1e-4, rtol=0)
    for o, e in zip(ms, exp_ms):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


def test_conv_tiny():
    x = np.random.default_rng(5).normal(size=(2, 20, 20)).astype(np.float32)
    jm = JConvTiny()
    v = _init(jm, 5, x)
    expected = jm.apply(v, x)
    port = _bridge(ConvTiny(), v, "bbox_head.update_importance.", "bbox_head",
                   "update_importance")
    with torch.no_grad():
        out = port(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-4, rtol=0)
