"""Every published config of the one-stage zoo (``configs/psgtr``,
``configs/psgformer``, ``configs/baseline``, ``configs/detr4seg``, R-50 and
R-101) builds in the port at full width with exactly the JAX package's
variables: the flax shape tree comes from ``jax.eval_shape`` of the JAX
model's ``init`` (nothing compiled), and every port tensor takes a leaf of
that tree of its shape, every leaf taken. Also the dispatch of each head's
loss and post-processing, and the heads still to port raising with their
ROADMAP item (the box head is built in ``test_torch_bbox_configs.py``)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.train.builder import build_detector as j_build_detector
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.train.dispatch import get_loss_fn, get_postprocess_fn  # noqa: E402
from pairnet_torch.utils.from_jax import port_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for d in ("psgtr", "psgformer", "baseline", "detr4seg")
                 for p in glob.glob(os.path.join(REPO, "configs", d, "*.py")))


def test_the_zoo_has_ten_configs():
    assert len(CONFIGS) == 10, CONFIGS


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_with_jax_variable_shapes(config):
    path = os.path.join(REPO, "configs", config)
    jm = j_build_detector(j_load_config(path))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    # zero-copy stand-ins of the leaves' shapes: the layout changes are views
    trees = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   {c: dict(shapes[c]) for c in ("params", "constants")})
    model = build_model(load_config(path).model, device="cpu")
    arrays = port_arrays(model, trees)  # raises on a missing leaf or one left over
    state = model.state_dict()
    assert set(arrays) == set(state), sorted(set(arrays) ^ set(state))
    for k, a in arrays.items():
        assert tuple(state[k].shape) == a.shape, k
    cfg = load_config(path)
    head = cfg.model.bbox_head.type
    get_postprocess_fn(head)
    fn = get_loss_fn(head, cfg)
    assert fn.cum_size(56) == 56 + int(bool(cfg.get("loss", {}).get("use_seesaw")))


def test_default_device_is_cuda():
    """The zoo builds on CUDA unless the CPU is asked for."""
    cfg = load_config(os.path.join(REPO, "configs", "psgtr", "psgtr_r50_psg.py"))
    if torch.cuda.is_available():
        assert next(build_model(cfg.model).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg.model)


@pytest.mark.parametrize("config, item", [
    ("motifs/panoptic_fpn_r50_predcls_psg.py", "MotifHead"),
    ("imp/panoptic_fpn_r50_sgdet_psg.py", "IMPHead"),
])
def test_heads_still_to_port_raise(config, item):
    """The two-stage configs, the last the port lacked, now build (their
    own tests are ``test_torch_twostage_configs.py``); a relation head the
    JAX package does not have still raises, naming ROADMAP queue A."""
    cfg = load_config(os.path.join(REPO, "configs", config))
    model = build_model(cfg.model, device="cpu")
    assert type(model).__name__ == "SceneGraphTwoStage"
    assert type(model.relation_head).__name__ == item
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        build_model(cfg.model.merge({"relation_head": {"type": "SGTransformerHead"}}),
                    device="cpu")
