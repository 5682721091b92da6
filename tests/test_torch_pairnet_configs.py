"""The Pair-Net configs and matrix learners of the port against
``pairnet_tpu``, module by module (f32, CPU): each of the four ablation
matrix learners alone on a random affinity, and every config under
``configs/pairnet/`` built by the port's ``build_model`` at full width
against the JAX package's variable tree of the same config (shapes only,
from ``jax.eval_shape``; no forward at full width).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.models.frameworks.psgtr import build_model as j_build_model
from pairnet_tpu.models.heads.matrix_learner import MAPPERS as J_MAPPERS
from test_torch_helpers import nest, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.flagship import init_weights  # noqa: E402
from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.backbones.swin import SwinTransformer  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.models.heads.matrix_learner import MAPPERS, create_mapper  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables, port_arrays  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "pairnet")
MAPPER_ATOL = 1e-5  # x max(1, max |ref|)
_jax_shapes = {}  # repr of a model config -> its JAX variable shapes (configs share models)


def _mapper(name):
    """The matrix learner ``name`` for a 20 x 20 affinity, allocated but not
    initialised: building on meta draws nothing from torch's global random
    stream, which other test files seed at import."""
    with torch.device("meta"):
        mapper = create_mapper(name, 20)
    return mapper.to_empty(device="cpu")


@pytest.mark.parametrize("name", ["conv_small", "conv_base", "attn", "fc"])
def test_mapper_matches_jax(name):
    """Each matrix learner alone on a random (2, 20, 20) affinity."""
    x = np.random.default_rng(3).normal(size=(2, 20, 20)).astype(np.float32)
    jm = J_MAPPERS[name]()
    variables = perturb(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)), seed=4)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    port = load_jax_variables(_mapper(name),
                              {"params": nest(variables["params"], "bbox_head",
                                              "update_importance")},
                              prefix="bbox_head.update_importance.")
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=MAPPER_ATOL * max(1.0, np.abs(ref).max()), rtol=0)


def test_mapper_computes_in_the_affinity_type():
    """bf16 weights on an f32 affinity compute in f32, as flax promotes
    (the bf16 serving path); an f32 copy of the weights gives the same."""
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 20, 20)).astype(np.float32))
    for name in MAPPERS:
        m16 = init_weights(_mapper(name), seed=0).to(torch.bfloat16)
        with torch.no_grad():
            got = m16(x)
            want = m16.float()(x)
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got, want)  # f32 tolerances: the same values


@pytest.mark.parametrize("path", sorted(p for p in os.listdir(CONFIGS) if p.endswith(".py")))
def test_every_pairnet_config_builds(path):
    """Each config under ``configs/pairnet/`` builds in the port on the CPU
    with the backbone, matrix learner and head mode it names, and the JAX
    package's variables of the same config would fill it exactly."""
    cfg = load_config(os.path.join(CONFIGS, path))
    model = build_model(cfg.model, device="cpu")
    head_cfg = cfg.model.bbox_head
    backbones = {"ResNet": ResNet, "SwinTransformer": SwinTransformer}
    assert type(model.backbone) is backbones[cfg.model.backbone.type]
    assert type(model.bbox_head.update_importance) is MAPPERS[head_cfg.get("mapper",
                                                                           "conv_tiny")]
    assert hasattr(model.bbox_head, "pair_embed") == bool(head_cfg.get("direct", False))
    assert not model.training
    j_model_cfg = j_load_config(os.path.join(CONFIGS, path)).model
    key = repr(j_model_cfg)
    if key not in _jax_shapes:
        jm = j_build_model(j_model_cfg)
        _jax_shapes[key] = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 64, 64, 3)))
    shapes = _jax_shapes[key]
    zeros = {col: jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                         shapes[col]) for col in ("params", "constants")
             if col in shapes}
    arrays = port_arrays(model, zeros)  # raises on a missing or an unused leaf
    state = model.state_dict()
    assert set(arrays) == set(state)
    assert all(arrays[k].shape == tuple(v.shape) for k, v in state.items())
