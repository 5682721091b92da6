"""The two-stage configs and converters in the port against ``pairnet_tpu``:
every config under ``configs/{motifs,imp,gpsnet,vctree}/`` built by the
port's ``build_model`` at full width with exactly the JAX package's
variables (shapes from ``jax.eval_shape`` of JAX's init, nothing compiled;
the sgdet configs' ``detector`` node, which JAX's builder cannot take, is
left out of JAX's build); ``convert_panoptic_fpn`` (with and without the
mask and semantic heads, the Faster R-CNN subset) and
``convert_{motif,imp,gps,vctree}_head`` reading every key of the port's
``state_dict()`` and giving JAX's variable tree, which
``load_jax_variables`` carries back bit for bit."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.models.frameworks.psgtr import build_model as j_build_model
from pairnet_tpu.utils import torch_convert
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.train.dispatch import get_loss_fn, get_postprocess_fn  # noqa: E402
from pairnet_torch.utils.from_jax import _leaves, load_jax_variables, port_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for d in ("motifs", "imp", "gpsnet", "vctree")
                 for p in glob.glob(os.path.join(REPO, "configs", d, "*.py")))
COLLECTIONS = ("params", "constants", "batch_stats")
N, P = 6, 10  # objects and pairs of the init batch: no variable depends on them
_jax_shapes = {}


def init_batch(num_classes):
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 40, (1, N, 2))
    return {"image": jnp.zeros((1, 64, 64, 3)),
            "det_boxes": jnp.asarray(np.concatenate([xy, xy + 10], -1), jnp.float32),
            "det_labels": jnp.ones((1, N), jnp.int32), "det_valid": jnp.ones((1, N), bool),
            "det_dists": jnp.full((1, N, num_classes), 1.0 / num_classes),
            "pairs": jnp.asarray(rng.integers(0, N, (1, P, 2)), jnp.int32),
            "pair_valid": jnp.ones((1, P), bool), "pair_labels": jnp.zeros((1, P), jnp.int32),
            "image_shape": jnp.asarray([[64, 64]], jnp.int32)}


def jax_shapes(config):
    """The flax shape tree of ``config``'s JAX model (JAX's own init batch
    shape; its heads outside predcls read ``det_dists``)."""
    if config not in _jax_shapes:
        cfg = j_load_config(os.path.join(REPO, "configs", config))
        model_cfg = {k: v for k, v in dict(cfg.model).items() if k != "detector"}
        jm = j_build_model(model_cfg)
        batch = init_batch(cfg.model.relation_head.num_classes)
        _jax_shapes[config] = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    return _jax_shapes[config]


def zero_trees(shapes):
    """Zero-copy stand-ins of the leaves' shapes: the layout changes are views."""
    return jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  {c: dict(shapes.get(c, {})) for c in COLLECTIONS})


def test_the_two_stage_family_has_nineteen_configs():
    assert len(CONFIGS) == 19, CONFIGS


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_with_jax_variable_shapes(config):
    shapes = jax_shapes(config)
    cfg = load_config(os.path.join(REPO, "configs", config))
    model = build_model(cfg.model, device="cpu")
    arrays = port_arrays(model, zero_trees(shapes))  # raises on a missing leaf or one left over
    state = model.state_dict()
    assert set(arrays) == set(state), sorted(set(arrays) ^ set(state))
    for k, a in arrays.items():
        assert tuple(state[k].shape) == a.shape, k
    head = cfg.model.relation_head.type
    get_postprocess_fn(head)
    fn = get_loss_fn(head, cfg)
    assert fn.num_points == 0 and fn.cum_size(56) == 56


class Tracked(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return dict.__getitem__(self, k)


HEAD_CONVERTERS = {"motifs/panoptic_fpn_r50_sgdet_psg.py": "convert_motif_head",
                   "imp/panoptic_fpn_r50_sgdet_psg.py": "convert_imp_head",
                   "gpsnet/panoptic_fpn_r50_sgdet_psg.py": "convert_gps_head",
                   "vctree/panoptic_fpn_r50_sgdet_psg.py": "convert_vctree_head"}
# (the converters read the label decoder / object classifier, which the
# predcls heads lack in both packages: closure holds on the sgdet models)


@pytest.mark.parametrize("config", list(HEAD_CONVERTERS))
def test_head_converter_closure(config):
    """``convert_*_head`` reads every ``relation_head.*`` key of the port's
    state dict and gives JAX's relation-head tree (params and batch_stats),
    which ``load_jax_variables`` carries back bit for bit; the backbone's
    keys go through ``convert_resnet``."""
    cfg = load_config(os.path.join(REPO, "configs", config))
    model = build_model(cfg.model, device="cpu", seed=3)
    sd = Tracked({k: v.numpy() for k, v in model.state_dict().items()})
    head = getattr(torch_convert, HEAD_CONVERTERS[config])(sd, prefix="relation_head.")
    bb_params, bb_consts = torch_convert.convert_resnet(sd, "backbone.")
    unread = {k for k in sd if not k.startswith("neck.")} - sd.read
    assert not unread, sorted(unread)
    shapes = jax_shapes(config)
    for col in ("params", "batch_stats"):
        want = {k: v.shape for k, v in _leaves(dict(shapes[col]["relation_head"]))}
        got = {k: np.shape(v) for k, v in _leaves(head[col])}
        assert want == got, sorted(set(want) ^ set(got))
    neck = {k: v.shape for k, v in _leaves(dict(shapes["params"]["neck"]))}
    variables = {"params": {"relation_head": head["params"],
                            "backbone": torch_convert.unflatten(bb_params),
                            "neck": _neck_tree(sd, neck)},
                 "constants": {"backbone": torch_convert.unflatten(bb_consts)},
                 "batch_stats": {"relation_head": head["batch_stats"]}}
    again = load_jax_variables(build_model(cfg.model, device="cpu", seed=4), variables)
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _neck_tree(sd, shapes):
    """The two-stage model's FPN through ``convert_panoptic_fpn``'s mapping
    of mmdet's FPN (the converters of the relation heads leave it out)."""
    p = {}
    for i in range(4):
        torch_convert._conv(p, f"lateral_{i}", sd, f"neck.lateral_convs.{i}.conv")
        torch_convert._conv(p, f"fpn_conv_{i}", sd, f"neck.fpn_convs.{i}.conv")
    tree = torch_convert.unflatten(p)
    assert {k: v.shape for k, v in _leaves(tree)} == shapes
    return tree


@pytest.fixture(scope="module")
def panoptic_fpn():
    """The port's full-width Panoptic FPN (R-50, 80 things, 53 stuff) and
    JAX's variable shapes of it."""
    from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
    from pairnet_tpu.models.frameworks.panoptic_fpn import PanopticFPN as JPanopticFPN

    det_cfg = {"type": "PanopticFPN", "backbone": {"type": "ResNet", "depth": 50},
               "num_things": 80, "num_stuff": 53}
    jm = JPanopticFPN(backbone=JResNet(depth=50), num_things=80, num_stuff=53)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            jnp.ones((1, 2), jnp.int32), with_masks=True))
    return build_model(det_cfg, device="cpu", seed=5), det_cfg, shapes


@pytest.mark.parametrize("subset", ["panoptic", "faster_rcnn"])
def test_panoptic_fpn_converter_closure(panoptic_fpn, subset):
    """``convert_panoptic_fpn`` reads every key of the port's state dict
    (the Faster R-CNN subset: every key but the mask and semantic heads')
    and gives JAX's tree (without those heads for the subset), which
    ``load_jax_variables`` carries back bit for bit."""
    port, det_cfg, shapes = panoptic_fpn
    drop = ("roi_head.mask_head.", "semantic_head.") if subset == "faster_rcnn" else ()
    sd = Tracked({k: v.numpy() for k, v in port.state_dict().items() if not k.startswith(drop)})
    back = torch_convert.convert_panoptic_fpn(sd)
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    skip = {"mask_head", "semantic_head"} if drop else set()
    for col in ("params", "constants"):
        want = {k: v.shape for k, v in _leaves(dict(shapes[col])) if k[0] not in skip}
        got = {k: np.shape(v) for k, v in _leaves(back[col])}
        assert want == got, sorted(set(want) ^ set(got))
    if not drop:
        again = load_jax_variables(build_model(det_cfg, device="cpu", seed=6), back)
        for k, v in again.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
