"""Port parity of the Pair-Net family beyond the R-50 / ConvTiny flagship:
the four other matrix learners, the direct head (no Relation Fusion) and
the Swin backbone, against ``pairnet_tpu`` (f32, CPU).

The tiny models are ``configs/pairnet/tiny_synthetic.py`` with one override
each, built by both packages' ``build_model``. Their variables are the JAX
init of the tiny R-50 / ConvTiny model where a leaf has the same path and
shape, and seeded lecun-normal kernels (ones for scales and variances,
zeros for biases and means) for the leaves the variant adds or reshapes,
then seeded noise on every leaf, as in ``tests/test_torch_pairnet.py``.
Images are 2x64x96; the discrete steps (attention masks, the top-k pair
pick) are held under that file's margin guards. The mappers alone and the
full-width configs are in ``tests/test_torch_pairnet_configs.py``.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import apply_overrides as j_apply_overrides
from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.models.frameworks.psgtr import build_model as j_build_model
from pairnet_tpu.train.optim import lr_mult_tree as j_lr_mult_tree
from pairnet_tpu.train.optim import norm_free_decay_mask as j_decay_mask
from test_torch_helpers import attention_mask_logits, decided_ranks, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import apply_overrides, load_config  # noqa: E402
from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.backbones.swin import SwinTransformer  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.models.heads.matrix_learner import MAPPERS  # noqa: E402
from pairnet_torch.train.optim import (  # noqa: E402
    DEFAULT_LR_KEYS,
    lr_mult_tree,
    norm_free_decay_mask,
)
from pairnet_torch.utils.from_jax import load_jax_variables, port_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
TINY_SWIN = dict(type="SwinTransformer", embed_dim=16, depths=(1, 1, 2, 1),
                 num_heads=(1, 2, 4, 8), window=4)
VARIANTS = {
    "conv_small": {"model.bbox_head.mapper": "conv_small"},
    "conv_base": {"model.bbox_head.mapper": "conv_base"},
    "attn": {"model.bbox_head.mapper": "attn"},
    "fc": {"model.bbox_head.mapper": "fc"},
    "direct": {"model.bbox_head.direct": True},
    "swin": {"model.backbone": TINY_SWIN},
}
ATOL = 1e-4  # x max(1, max |ref|), as tests/test_torch_pairnet.py
HW = (64, 96)


def _jax_model(overrides):
    cfg = j_apply_overrides(j_load_config(TINY), overrides)
    return j_build_model(cfg.model)


def _fill(shapes, base, rng, name=""):
    """A variable tree of ``shapes``: ``base``'s leaf where it has the same
    path and shape, else a seeded one."""
    if isinstance(shapes, Mapping):
        return {k: _fill(v, base.get(k) if isinstance(base, Mapping) else None, rng, k)
                for k, v in sorted(shapes.items())}
    if base is not None and np.shape(base) == shapes.shape:
        return np.asarray(base)
    if name in ("scale", "weight", "running_var"):
        return np.ones(shapes.shape, np.float32)
    if name in ("bias", "running_mean"):
        return np.zeros(shapes.shape, np.float32)
    fan_in = int(np.prod(shapes.shape[:-1])) if len(shapes.shape) > 1 else 1
    return (rng.normal(size=shapes.shape) / np.sqrt(fan_in)).astype(np.float32)


@pytest.fixture(scope="module")
def base_variables():
    jm = _jax_model({})
    return jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request, base_variables):
    """(name, JAX outputs, port outputs, JAX variables, port model, images,
    JAX attention-mask bits)."""
    name = request.param
    overrides = VARIANTS[name]
    jm = _jax_model(overrides)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    filled = _fill(shapes, base_variables, np.random.default_rng(7))
    variables = perturb(filled, seed=2, std=0.05)
    images = np.random.default_rng(0).normal(size=(2, *HW, 3)).astype(np.float32)
    ref, state = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=lambda mdl, method: method == "attn_mask_small",
        mutable=["intermediates"]))(variables, images)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    bits = [np.asarray(b) for b in
            state["intermediates"]["bbox_head"]["transformer_decoder"]["attn_mask_small"]]
    cfg = apply_overrides(load_config(TINY), overrides)
    port = load_jax_variables(build_model(cfg.model, device="cpu"), variables)
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(torch.tensor(images)).items()}
    return name, ref, out, variables, port, images, bits


def test_variant_builds_the_configured_modules(variant):
    name, _, _, variables, port, _, _ = variant
    head = port.bbox_head
    assert isinstance(port.backbone, SwinTransformer if name == "swin" else ResNet)
    mapper = name if name in MAPPERS else "conv_tiny"
    assert type(head.update_importance) is MAPPERS[mapper]
    # a direct head owns no relation layers, as flax creates none it never calls
    has_relation = any(k.startswith("relation_layer_") for k in variables["params"]["bbox_head"])
    assert has_relation == (name != "direct") == hasattr(head, "relation_decoder")
    assert hasattr(head, "pair_embed") == (name == "direct")


@pytest.mark.parametrize("key", ["cls", "mask", "importance", "queries", "rel"])
def test_variant_forward_matches_jax(variant, key):
    _, ref, out, _, _, _, _ = variant
    assert out[key].shape == ref[key].shape
    np.testing.assert_allclose(out[key], ref[key],
                               atol=ATOL * max(1.0, np.abs(ref[key]).max()), rtol=0)


def test_variant_attention_masks_match_jax_where_decided(variant):
    """The sigmoid < 0.5 attention masks: every bit whose logit lies further
    from 0 than 10x the largest gap between the two packages' final mask
    logits (the same contraction at full resolution) equals JAX's bit. A
    margin guard as in ``test_torch_pairnet.py``, held bit by bit: among
    this many logits one may lie within the gap of 0, and its bit is then
    not decided by the numerics."""
    _, ref, out, _, port, images, bits = variant
    gap = np.abs(out["mask"] - ref["mask"]).max()
    logits = attention_mask_logits(port, images)
    assert len(logits) == len(bits)
    n_bits = n_undecided = 0
    for am, jbits in zip(logits, bits):
        assert am.shape == jbits.shape
        decided = np.abs(am) > 10 * gap
        n_bits += am.size
        n_undecided += int((~decided).sum())
        np.testing.assert_array_equal((am < 0)[decided], jbits[decided])
    assert n_undecided <= 1e-3 * n_bits, (n_undecided, n_bits)


def test_variant_pair_indices_match_under_margin(variant):
    _, ref, out, _, _, _, _ = variant
    B, Q, _ = ref["importance"].shape
    K = ref["sub_pos"].shape[1]
    tol = ATOL * max(1.0, np.abs(ref["importance"]).max())
    n_decided = 0
    for b in range(B):
        ok = decided_ranks(ref["importance"][b].ravel(), K, tol)
        n_decided += ok.sum()
        np.testing.assert_array_equal(out["sub_pos"][b][ok], ref["sub_pos"][b][ok])
        np.testing.assert_array_equal(out["obj_pos"][b][ok], ref["obj_pos"][b][ok])
    assert n_decided >= B * K // 2, n_decided


def test_variant_lr_mults_and_decay_mask_match_jax(variant):
    """As ``tests/test_torch_train.py``, on every variant: the Swin backbone
    takes 0.1 like every backbone parameter (the ResNet-only frozen keys
    match nothing), the direct head's ``pair_embed`` 1.0."""
    name, _, _, variables, model, _, _ = variant
    params = variables["params"]
    j_mults = j_lr_mult_tree(params, DEFAULT_LR_KEYS)
    j_mask = j_decay_mask(params)

    def as_arrays(tree):  # each leaf's value over its parameter's shape
        filled = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                        tree, params)
        return port_arrays(model, {"params": filled})

    want_mult, want_mask = as_arrays(j_mults), as_arrays(j_mask)
    got_mult = lr_mult_tree(model, DEFAULT_LR_KEYS)
    got_mask = norm_free_decay_mask(model)
    assert set(got_mult) == set(want_mult) == set(got_mask)
    for pname in got_mult:
        assert np.all(want_mult[pname] == got_mult[pname]), pname
        assert np.all(want_mask[pname] == float(got_mask[pname])), pname
    if name == "swin":
        backbone = {m for n, m in got_mult.items() if n.startswith("backbone.")}
        assert backbone == {0.1}
        assert got_mask["backbone.stages.0.blocks.0.attn.w_msa.relative_position_bias_table"]
        assert not got_mask["backbone.stages.0.downsample.norm.weight"]
    if name == "direct":
        assert got_mult["bbox_head.pair_embed.0.weight"] == 1.0
