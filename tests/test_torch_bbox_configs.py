"""The box Pair-Net's configs and weights in the port against ``pairnet_tpu``:
every config under ``configs/deformable_detr/`` and ``configs/oiv6/`` built
by the port's ``build_model`` at full width with exactly the JAX package's
variables (shapes from ``jax.eval_shape`` of JAX's init, nothing compiled);
``convert_crosshead_bbox_checkpoint`` taking the port's ``state_dict()`` of
the R-50, R-101 and ResNeXt-101 models with no key missing or left over; a
tiny ResNeXt against JAX's; the dispatch of the box head, and the
two-stage models still raising with their ROADMAP item."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.models.backbones.resnet import ResNeXt as JResNeXt
from pairnet_tpu.train.builder import build_detector as j_build_detector
from pairnet_tpu.utils.torch_convert import convert_crosshead_bbox_checkpoint
from test_torch_helpers import keep_torch_rng, numpy_init, perturb  # noqa: F401

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.models.backbones.resnet import ResNeXt  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.train.dispatch import get_loss_fn, get_postprocess_fn  # noqa: E402
from pairnet_torch.utils.from_jax import _leaves, load_jax_variables, port_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for d in ("deformable_detr", "oiv6")
                 for p in glob.glob(os.path.join(REPO, "configs", d, "*.py")))
# the encoder's top-k takes num_obj_query (300 for COCO) of the S proposals:
# 256x256 gives S = 1360
INIT_HW = (256, 256)
_jax_shapes = {}


def jax_shapes(config):
    """The flax shape tree of ``config``'s JAX model (one eval_shape per
    model config that differs in more than its box-refinement flags, which
    change no variable)."""
    cfg = j_load_config(os.path.join(REPO, "configs", config))
    head = {k: v for k, v in dict(cfg.model.get("bbox_head", {})).items()
            if k not in ("with_box_refine", "as_two_stage")}
    key = repr({**dict(cfg.model), "bbox_head": head})
    if key not in _jax_shapes:
        jm = j_build_detector(cfg)
        _jax_shapes[key] = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, *INIT_HW, 3)))
    return _jax_shapes[key]


def test_the_bbox_family_has_twelve_configs():
    assert len(CONFIGS) == 12, CONFIGS


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_with_jax_variable_shapes(config):
    shapes = jax_shapes(config)
    # zero-copy stand-ins of the leaves' shapes: the layout changes are views
    trees = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   {c: dict(shapes.get(c, {})) for c in ("params", "constants")})
    cfg = load_config(os.path.join(REPO, "configs", config))
    model = build_model(cfg.model, device="cpu")
    arrays = port_arrays(model, trees)  # raises on a missing leaf or one left over
    state = model.state_dict()
    assert set(arrays) == set(state), sorted(set(arrays) ^ set(state))
    for k, a in arrays.items():
        assert tuple(state[k].shape) == a.shape, k
    head = cfg.model.bbox_head.type
    get_postprocess_fn(head)
    fn = get_loss_fn(head, cfg)
    if head == "CrossHeadBBox":  # cross_swinb_vg.py is the Mask2Former Pair-Net on VG
        assert fn.num_points == 0 and fn.cum_size(50) == 50


@pytest.mark.parametrize("config", ["deformable_detr/cross_r50_coco.py",
                                    "deformable_detr/pairnet_r101_vg.py",
                                    "deformable_detr/pairnet_rnext101_vg.py"],
                         ids=["R-50", "R-101", "ResNeXt-101"])
def test_checkpoint_converter_closure(config):
    """The JAX package's ``convert_crosshead_bbox_checkpoint`` reads every key
    of the port's ``state_dict()`` (the reference checkpoint's names) and
    gives back exactly JAX's variable tree, which ``load_jax_variables``
    carries back into the port bit for bit."""
    model = build_model(load_config(os.path.join(REPO, "configs", config)).model,
                        device="cpu", seed=3)

    class Tracked(dict):
        read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    sd = Tracked({k: v.numpy() for k, v in model.state_dict().items()})
    back = convert_crosshead_bbox_checkpoint(sd)
    assert set(sd) == sd.read, sorted(set(sd) - sd.read)
    shapes = jax_shapes(config)
    for col in ("params", "constants"):
        want = {k: v.shape for k, v in _leaves(dict(shapes[col]))}
        got = {k: np.shape(v) for k, v in _leaves(back[col])}
        assert want == got, sorted(set(want) ^ set(got))
    again = load_jax_variables(build_model(load_config(os.path.join(REPO, "configs", config))
                                           .model, device="cpu", seed=4), back)
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_tiny_resnext_matches_jax():
    """A tiny ResNeXt (depth 26, 4 groups, base width 8, stem 16; the JAX
    package's own test's) on seeded weights: the four stages."""
    jm = JResNeXt(depth=26, groups=4, base_width=8, stem_width=16)
    x = np.random.default_rng(0).normal(size=(1, 64, 96, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = perturb(numpy_init(shapes, 5), seed=6, std=0.1)
    want = jax.jit(jm.apply)(variables, x)
    port = load_jax_variables(ResNeXt(depth=26, groups=4, base_width=8, stem_width=16).eval(),
                              {c: {"backbone": variables[c]} for c in variables},
                              prefix="backbone.")
    with torch.no_grad():
        got = port(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0)


def test_box_head_builds_and_defaults_to_cuda():
    """The box head and ResNeXt build; the default device is CUDA."""
    cfg = load_config(os.path.join(REPO, "configs", "deformable_detr", "pairnet_r101_vg.py"))
    if torch.cuda.is_available():
        assert next(build_model(cfg.model).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg.model)


@pytest.mark.parametrize("config", ["imp/panoptic_fpn_r50_sgdet_psg.py",
                                    "motifs/panoptic_fpn_r50_predcls_psg.py"])
def test_two_stage_models_raise_naming_their_item(config):
    cfg = load_config(os.path.join(REPO, "configs", config))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*A\.2-A\.3"):
        build_model(cfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.2-A\.3"):
        get_loss_fn(cfg.model.relation_head.type, cfg)
