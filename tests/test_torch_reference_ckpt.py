"""Reference PyTorch checkpoints through the port's ``--load-from`` against the
JAX package's converters (f32, CPU).

For every family that ``pairnet_tpu/utils/torch_convert.py`` converts, a
tiny model of it (the widths of its own parity test) is given seeded
weights, and the port's ``state_dict()`` of them is written as the
reference would save it: mmcv's ``{"meta", "state_dict", "optimizer"}``
layout, with the buffers the reference's modules hold and the port's do
not (``num_batches_tracked`` of every BatchNorm, Swin's
``relative_position_index``, and in a two-stage relation checkpoint the
frozen detector's heads). The Mask2Former file holds the segmenter's keys
only, under ``panoptic_head``. Then, from the same fresh variables in both
packages:

* JAX: the family's ``convert_*_checkpoint`` (through a mapping that
  records the keys it reads) and ``merge_pretrained``;
* the port: ``load_pretrained(model, "<file>.pth")``.

Checked per family: the two forwards agree within the tolerance of the
family's own parity test; the keys the port skips are exactly the keys the
JAX converter leaves unread; every loaded tensor equals the file's, and
every other keeps its init (for Mask2Former: PPN and Relation Fusion).
Then the loader's errors: an unknown key, a shape mismatch, a pickled
object in the file.
"""

import os
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import apply_overrides as j_apply_overrides
from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.models.backbones.resnet import ResNet as JResNet
from pairnet_tpu.models.frameworks import panoptic_fpn as j_pfpn
from pairnet_tpu.models.frameworks.psgtr import PSGTr as JPSGTr
from pairnet_tpu.models.frameworks.psgtr import build_model as j_build_model
from pairnet_tpu.models.frameworks.twostage import SceneGraphTwoStage as JTwoStage
from pairnet_tpu.models.heads import baseline_head as j_base
from pairnet_tpu.models.heads import pairnet_bbox_head as jb
from pairnet_tpu.models.heads import psgtr_head as j_psgtr
from pairnet_tpu.models.heads.psgformer_head import PSGFormerHead as JPSGFormer
from pairnet_tpu.models.heads.twostage import heads as j_heads
from pairnet_tpu.models.heads.twostage import vctree as j_vctree
from pairnet_tpu.utils import torch_convert as tc
from test_torch_helpers import assert_close_rel, numpy_init, perturb, tree_leaves, tree_numpy
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import apply_overrides, load_config  # noqa: E402
from pairnet_torch.models.backbones.resnet import ResNet  # noqa: E402
from pairnet_torch.models.backbones.swin import WindowMSA, rel_pos_index  # noqa: E402
from pairnet_torch.models.frameworks import panoptic_fpn  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import PSGTr, build_model  # noqa: E402
from pairnet_torch.models.frameworks.twostage import SceneGraphTwoStage  # noqa: E402
from pairnet_torch.models.heads import baseline_head, pairnet_bbox_head  # noqa: E402
from pairnet_torch.models.heads import psgformer_head, psgtr_head  # noqa: E402
from pairnet_torch.models.heads.twostage import heads, vctree  # noqa: E402
from pairnet_torch.models.heads.twostage.core import RunningBatchNorm  # noqa: E402
from pairnet_torch.models.layers import FrozenBatchNorm  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables, load_pretrained  # noqa: E402
from pairnet_torch.utils.torch_convert import (  # noqa: E402
    SKIPPED_KINDS,
    load_reference_checkpoint,
    port_names,
    reference_state_dict,
    skipped_kind,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
TINY_SWIN = dict(type="SwinTransformer", embed_dim=16, depths=(1, 1, 2, 1),
                 num_heads=(1, 2, 4, 8), window=4)
HW = (64, 96)
# the segmenter of a Mask2Former checkpoint, in the port's Pair-Net names
SEGMENTER = ("backbone.", "bbox_head.pixel_decoder.", "bbox_head.transformer_decoder.",
             "bbox_head.query_feat.", "bbox_head.query_embed.", "bbox_head.level_embed.",
             "bbox_head.cls_embed.", "bbox_head.mask_embed.")
# Pair-Net's PPN (the query updates and the matrix learner) and Relation Fusion
PPN_AND_FUSION = ("bbox_head.sub_query_update.", "bbox_head.obj_query_update.",
                  "bbox_head.update_importance.", "bbox_head.rel_query_",
                  "bbox_head.relation_decoder.", "bbox_head.rel_cls_embed.")


class Family(NamedTuple):
    shapes: dict  # JAX's variable shapes
    jax_apply: Callable  # variables -> outputs (numpy)
    port: Callable  # variables -> the port model holding them
    port_apply: Callable  # port model -> outputs (numpy)
    convert: Callable  # reference state dict -> flax variables
    keys: tuple | None  # the outputs compared (None: every leaf)
    atol: float  # x max(1, max |JAX|), the family's parity test's
    weights: Callable | None = None  # shapes -> the checkpoint's variables


def _images(B=1, hw=HW):
    return np.random.default_rng(0).normal(size=(B, *hw, 3)).astype(np.float32)


def _pairnet(overrides):
    """The tiny Pair-Net of ``configs/pairnet/tiny_synthetic.py`` (as in
    ``tests/test_torch_pairnet_variants.py``)."""
    jm = j_build_model(j_apply_overrides(j_load_config(TINY), overrides).model)
    cfg = apply_overrides(load_config(TINY), overrides)
    images = _images()
    return Family(
        shapes=jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))),
        jax_apply=_jit_apply(jm, images),
        port=lambda v: load_jax_variables(build_model(cfg.model, device="cpu"), v),
        port_apply=_port_apply(images), convert=tc.convert_pairnet_checkpoint,
        keys=("cls", "mask", "importance", "queries", "rel"), atol=1e-4)


def _zoo(jax_head, port_head, kw, convert, keys):
    """A one-stage zoo model (ResNet-26 at base width 8, as
    ``test_torch_helpers.zoo_pair``)."""
    jm = JPSGTr(backbone=JResNet(depth=26, base_width=8), bbox_head=jax_head(**kw))
    images = _images()

    def port(v):
        bb = ResNet(depth=26, base_width=8)
        return load_jax_variables(PSGTr(bb, port_head(bb.out_channels, **kw)).eval(), v)

    return Family(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                  _jit_apply(jm, images), port, _port_apply(images), convert, keys, 1e-4)


DETR = dict(num_heads=4, num_encoder_layers=2, num_decoder_layers=2, embed_dims=32)
M2F = dict(num_heads=4, num_decoder_layers=3, pixel_decoder_layers=1, embed_dims=32)
BBOX = dict(num_classes=10, num_relations=5, num_obj_query=16, num_rel_query=12, embed_dims=32,
            num_heads=4, num_encoder_layers=2, num_decoder_layers=2, num_relation_layers=2,
            num_levels=4)


def _bbox():
    """The box Pair-Net of ``tests/test_torch_bbox_head.py``."""
    jm = JPSGTr(backbone=JResNet(depth=26, base_width=8), bbox_head=jb.CrossHeadBBox(**BBOX))
    images = _images(hw=(64, 64))

    def port(v):
        bb = ResNet(depth=26, base_width=8)
        model = PSGTr(bb, pairnet_bbox_head.CrossHeadBBox(**BBOX),
                      pairnet_bbox_head.ChannelMapper(bb.out_channels[1:], 32, 4))
        return load_jax_variables(model.eval(), v)

    return Family(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))),
                  _jit_apply(jm, images), port, _port_apply(images),
                  tc.convert_crosshead_bbox_checkpoint, None, 1e-4)


TWO_STAGE = dict(num_classes=8, num_predicates=6, hidden_dim=32, roi_dim=64,
                 context_pooling_dim=96, embed_dim=16, in_channels=16)
# (head in both packages, its converter, use_bias): IMP without the frequency
# bias, as every IMP config (``convert_imp_head`` reads none; ROADMAP C)
HEADS = {"motifs": (j_heads.MotifHead, heads.MotifHead, "convert_motif_head", True),
         "imp": (j_heads.IMPHead, heads.IMPHead, "convert_imp_head", False),
         "gpsnet": (j_heads.GPSHead, heads.GPSHead, "convert_gps_head", True),
         "vctree": (j_vctree.VCTreeHead, vctree.VCTreeHead, "convert_vctree_head", True)}


def _twostage_batch(seed=0, B=2, N=7, P=12, C=8, R=6):
    """An sgdet batch (``tests/test_torch_twostage.py``'s) with its image."""
    rng = np.random.default_rng(seed)
    H, W = HW
    x0, y0 = rng.uniform(0, W - 24, (B, N)), rng.uniform(0, H - 24, (B, N))
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 30, (B, N)), y0 + rng.uniform(4, 30, (B, N))],
                     -1).astype(np.float32)
    valid = rng.random((B, N)) < 0.75
    valid[:, :2] = True
    ordered = np.stack(np.nonzero(~np.eye(N, dtype=bool)), -1)
    return dict(image=_images(B), det_boxes=boxes,
                det_labels=np.where(valid, rng.integers(1, C, (B, N)), 0).astype(np.int32),
                det_valid=valid,
                pairs=np.stack([ordered[rng.permutation(len(ordered))[:P]] for _ in range(B)])
                .astype(np.int32),
                pair_valid=rng.random((B, P)) < 0.8,
                pair_labels=rng.integers(0, R, (B, P)).astype(np.int32),
                image_shape=np.array([[H, W]] * B, np.int32),
                det_dists=rng.dirichlet(np.ones(C), (B, N)).astype(np.float32))


def _convert_twostage(head_converter):
    """A two-stage relation checkpoint through the JAX package's converters:
    ``convert_resnet`` for the backbone, ``convert_panoptic_fpn``'s mapping
    of mmdet's FPN for the neck and ``convert_*_head`` for the relation head
    (``tests/test_torch_twostage_configs.py``'s composition)."""
    def convert(sd):
        bb_params, bb_consts = tc.convert_resnet(sd, "backbone.")
        neck = {}
        for i in range(4):
            tc._conv(neck, f"lateral_{i}", sd, f"neck.lateral_convs.{i}.conv")
            tc._conv(neck, f"fpn_conv_{i}", sd, f"neck.fpn_convs.{i}.conv")
        head = getattr(tc, head_converter)(sd, prefix="relation_head.")
        return {"params": {"backbone": tc.unflatten(bb_params), "neck": tc.unflatten(neck),
                           "relation_head": head["params"]},
                "constants": {"backbone": tc.unflatten(bb_consts)},
                "batch_stats": {"relation_head": head["batch_stats"]}}
    return convert


def _twostage(name):
    """A tiny sgdet relation model (ResNet-26 at base width 8, a 16-channel
    FPN, the relation head at ``tests/test_torch_twostage.py``'s widths)."""
    jcls, pcls, converter, use_bias = HEADS[name]
    kw = dict(TWO_STAGE, mode="sgdet", use_bias=use_bias)
    jm = JTwoStage(backbone=JResNet(depth=26, base_width=8), relation_head=jcls(**kw),
                   neck_channels=16)
    batch = _twostage_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jax.jit(jm.apply)

    def port(v):
        model = SceneGraphTwoStage(ResNet(depth=26, base_width=8), pcls(**kw), neck_channels=16)
        return load_jax_variables(model.eval(), v)

    def port_apply(model):
        with torch.no_grad():
            return tree_numpy(model({k: torch.as_tensor(v) for k, v in batch.items()}))

    return Family(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch),
                  lambda v: jax.tree_util.tree_map(np.asarray, fwd(v, jbatch)),
                  port, port_apply, _convert_twostage(converter), None, 1e-4,
                  lambda shapes: _positive_var(perturb(numpy_init(shapes, 1), 2, 0.05)))


def _positive_var(tree, name=""):
    """BatchNorm variances kept positive (``tests/test_torch_twostage.py``)."""
    if isinstance(tree, dict):
        return {k: _positive_var(v, k) for k, v in tree.items()}
    return np.asarray(np.abs(tree) + 0.5 if name == "var" else tree, np.float32)


PFPN = dict(num_things=5, num_stuff=3, num_proposals=24, max_dets=8, score_thr=0.1)


def _panoptic_fpn():
    """The tiny detector of ``tests/test_torch_panoptic_fpn.py``, with its
    weights' recipe (regressions scaled down, classifiers up)."""
    jd = j_pfpn.PanopticFPN(backbone=JResNet(depth=26, base_width=8), **PFPN)
    img = _images(2, (96, 128))
    shapes_in = np.array([[96, 128], [80, 120]], np.int32)
    fwd = jax.jit(lambda v, i, s: jd.apply(v, i, s, with_masks=True))

    def jax_apply(v):
        dets, sem, _ = fwd(v, img, shapes_in)
        return {"dets": {k: np.asarray(getattr(dets, k)) for k in
                         ("boxes", "labels", "valid", "scores", "dists")}, "sem": np.asarray(sem)}

    def port_apply(model):
        with torch.no_grad():
            dets, sem = model(torch.tensor(img), torch.tensor(shapes_in))
        return {"dets": {k: getattr(dets, k).numpy() for k in
                         ("boxes", "labels", "valid", "scores", "dists")}, "sem": sem.numpy()}

    def weights(shapes):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   perturb(numpy_init(shapes, 3), 4, 0.05))
        v["params"]["rpn_head"]["rpn_reg"]["kernel"] *= 0.05
        v["params"]["bbox_head"]["fc_reg"]["kernel"] *= 0.05
        v["params"]["bbox_head"]["fc_cls"]["kernel"] *= 3
        v["params"]["mask_head"]["conv_logits"]["kernel"] *= 3
        return v

    return Family(
        jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), img, shapes_in, with_masks=True)),
        jax_apply,
        lambda v: load_jax_variables(
            panoptic_fpn.PanopticFPN(ResNet(depth=26, base_width=8), **PFPN).eval(), v),
        port_apply, tc.convert_panoptic_fpn, None, 1e-4, weights)


def _jit_apply(jm, images):
    fwd = jax.jit(jm.apply)
    return lambda v: jax.tree_util.tree_map(np.asarray, fwd(v, images))


def _port_apply(images):
    def apply(model):
        with torch.no_grad():
            return tree_numpy(model(torch.tensor(images)))
    return apply


FAMILIES = {
    "pairnet_r50": lambda: _pairnet({}),
    "pairnet_swin": lambda: _pairnet({"model.backbone": TINY_SWIN}),
    "mask2former": lambda: _pairnet({}),
    "psgtr": lambda: _zoo(j_psgtr.PSGTrHead, psgtr_head.PSGTrHead,
                          dict(num_classes=7, num_relations=5, num_query=12, **DETR),
                          tc.convert_psgtr_checkpoint, ("sub_seg", "rel")),
    "psgformer": lambda: _zoo(JPSGFormer, psgformer_head.PSGFormerHead,
                              dict(num_classes=7, num_relations=5, num_obj_query=12,
                                   num_rel_query=10, **DETR),
                              tc.convert_psgformer_checkpoint, ("mask", "rel")),
    "baseline": lambda: _zoo(j_base.BaselineHead, baseline_head.BaselineHead,
                             dict(num_classes=7, num_relations=5, num_obj_query=20,
                                  num_rel_query=16, num_relation_layers=2, **M2F),
                             tc.convert_baseline_checkpoint, ("mask", "rel", "subject_scores")),
    "bbox_pairnet": _bbox,
    **{name: (lambda name=name: _twostage(name)) for name in HEADS},
    "panoptic_fpn": _panoptic_fpn,
}


class Recording(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return dict.__getitem__(self, k)


def reference_extras(model) -> dict:
    """The buffers of the reference's modules that the port's do not hold:
    mmdet BatchNorm's ``num_batches_tracked`` and Swin's
    ``relative_position_index``."""
    extra = {}
    for name, m in model.named_modules():
        if isinstance(m, (FrozenBatchNorm, RunningBatchNorm)):
            extra[f"{name}.num_batches_tracked"] = torch.tensor(7)
        elif isinstance(m, WindowMSA):
            extra[f"{name}.relative_position_index"] = rel_pos_index(
                m.window, torch.device("cpu")).reshape(m.window ** 2, -1).clone()
    return extra


def detector_heads() -> dict:
    """The frozen detector's heads in a two-stage relation checkpoint
    (mmdet's Panoptic FPN names, as the reference's ``SceneGraphPanopticFPN``
    saves them)."""
    det = panoptic_fpn.PanopticFPN(ResNet(depth=26, base_width=8), **PFPN)
    return {k: v for k, v in det.state_dict().items()
            if k.startswith(("rpn_head.", "roi_head.", "semantic_head."))}


def as_npz(tree) -> dict:
    """A converted tree as JAX's ``--load-from`` reads it back from its
    ``.npz`` (flattened with "/", then ``unflatten``): empty subtrees, such
    as the Swin converter's empty ``constants``, are gone."""
    flat = {"/".join(k.split(".")): v for k, v in tree_leaves(tree)}
    return tc.unflatten(flat)


def save_mmcv(path, state_dict, meta=None):
    """``state_dict`` in the layout of mmcv 1.7's ``save_checkpoint``."""
    torch.save({"meta": meta or {"mmdet_version": "2.25.3", "epoch": 12, "iter": 3000,
                                 "CLASSES": ("person", "sky")},
                "state_dict": state_dict,
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0, 1]}]}},
               path)
    return str(path)


@pytest.fixture(scope="module", params=list(FAMILIES))
def loaded(request, tmp_path_factory):
    """One family's checkpoint written and loaded both ways: the file's
    state dict, the keys the JAX converter read, the keys the port skipped,
    the fresh and the loaded port state, and both forwards."""
    name = request.param
    fam = FAMILIES[name]()
    weights = (fam.weights or (lambda s: perturb(numpy_init(s, 1), 2, 0.05)))(fam.shapes)
    # the fresh models' init: a family's own recipe (which keeps what its
    # discrete steps need) scaled, else other seeds
    fresh = (jax.tree_util.tree_map(lambda a: a * np.float32(1.01), weights) if fam.weights
             else perturb(numpy_init(fam.shapes, 5), 6, 0.05))
    src = fam.port(weights)
    sd = {**src.state_dict(), **reference_extras(src)}
    if isinstance(src, SceneGraphTwoStage):
        sd.update(detector_heads())
    if name == "mask2former":
        sd = {k.replace("bbox_head.", "panoptic_head.", 1): v for k, v in sd.items()
              if k.startswith(SEGMENTER)}
    path = save_mmcv(tmp_path_factory.mktemp(name) / f"{name}.pth", sd)

    file_sd = Recording(torch.load(path, map_location="cpu", weights_only=True)["state_dict"])
    convert = tc.convert_mask2former_checkpoint if name == "mask2former" else fam.convert
    ref = fam.jax_apply(tc.merge_pretrained(fresh, as_npz(convert(file_sd))))

    init = fam.port(fresh)
    init_state = {k: v.clone() for k, v in init.state_dict().items()}
    model = load_pretrained(init, path)
    _, skipped = port_names(model, reference_state_dict(path))
    return dict(name=name, fam=fam, file=dict(file_sd), read=file_sd.read, skipped=skipped,
                init=init_state, state=model.state_dict(), ref=ref, out=fam.port_apply(model))


def test_forward_equals_the_jax_converters(loaded):
    """The port's forward from the ``.pth`` equals JAX's forward from its
    converter and ``merge_pretrained`` on the same file."""
    fam, ref, out = loaded["fam"], loaded["ref"], loaded["out"]
    got = dict(tree_leaves(out))
    want = dict(tree_leaves(ref))
    keys = [k for k in want if fam.keys is None or k.split(".")[0] in fam.keys]
    assert keys and set(want) == set(got), sorted(set(want) ^ set(got))
    for k in keys:
        if np.issubdtype(np.asarray(want[k]).dtype, np.floating):
            assert_close_rel(got[k], want[k], fam.atol, k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_skipped_keys_are_the_keys_jax_leaves_unread(loaded):
    """The reference keys the port skips (by kind) are exactly those the JAX
    converter never reads, and each family's file has some."""
    file_keys, skipped = set(loaded["file"]), loaded["skipped"]
    assert skipped and set(skipped) == file_keys - loaded["read"], sorted(
        set(skipped) ^ (file_keys - loaded["read"]))
    kinds = {k.rsplit(".", 1)[-1] if not k.startswith(("rpn_head.", "roi_head.",
                                                       "semantic_head.")) else "detector"
             for k in skipped}
    assert kinds <= set(SKIPPED_KINDS)
    want = ({"relative_position_index"} if loaded["name"] == "pairnet_swin"  # no BatchNorm
            else {"num_batches_tracked", "detector"} if loaded["name"] in HEADS
            else {"num_batches_tracked"})
    assert kinds == want, kinds


def test_loaded_tensors_equal_the_file_and_the_rest_keep_their_init(loaded):
    """Every tensor the file names holds the file's values; every other one
    its init. A full checkpoint names every tensor; the Mask2Former one
    leaves PPN and Relation Fusion, and only those, at their init."""
    state, init = loaded["state"], loaded["init"]
    named = {k.replace("panoptic_head.", "bbox_head.", 1): v for k, v in loaded["file"].items()
             if k not in loaded["skipped"]}
    for k, v in named.items():
        assert torch.equal(state[k], v), k
    rest = sorted(set(state) - set(named))
    for k in rest:
        assert torch.equal(state[k], init[k]), k
    if loaded["name"] == "mask2former":
        assert rest and all(k.startswith(PPN_AND_FUSION) for k in rest), rest
        assert {p for p in PPN_AND_FUSION if any(k.startswith(p) for k in rest)} == set(
            PPN_AND_FUSION)
    else:
        assert not rest, rest


@pytest.fixture(scope="module")
def tiny_state():
    """A seeded tiny flagship's state dict with the reference's extra buffers."""
    model = build_model(load_config(TINY).model, device="cpu", seed=3)
    return {**model.state_dict(), **reference_extras(model)}


def test_unknown_key_raises(tiny_state, tmp_path):
    path = save_mmcv(tmp_path / "u.pth", {**tiny_state, "bbox_head.no_such.weight":
                                          torch.zeros(2)})
    model = build_model(load_config(TINY).model, device="cpu", seed=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="bbox_head.no_such.weight"):
        load_pretrained(model, path)
    # nothing was copied before the check, and a num_batches_tracked of a
    # module that is not a BatchNorm is an unknown key too
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(KeyError, match="rel_cls_embed.num_batches_tracked"):
        load_reference_checkpoint(model, {**tiny_state, "bbox_head.rel_cls_embed."
                                                         "num_batches_tracked": torch.tensor(0)})


def test_shape_mismatch_raises(tiny_state, tmp_path):
    bad = dict(tiny_state)
    bad["bbox_head.rel_cls_embed.weight"] = bad["bbox_head.rel_cls_embed.weight"][:-1]
    with pytest.raises(ValueError, match="shape mismatch at bbox_head.rel_cls_embed.weight"):
        load_pretrained(build_model(load_config(TINY).model, device="cpu"),
                        save_mmcv(tmp_path / "s.pth", bad))


class NotATensor:
    pass


def test_bare_state_dict_loads_and_pickled_objects_are_refused(tiny_state, tmp_path):
    """A bare state dict file loads like the mmcv layout; a file holding a
    pickled object is refused by ``weights_only``, never unpickled."""
    torch.save(tiny_state, tmp_path / "bare.pth")
    model = load_pretrained(build_model(load_config(TINY).model, device="cpu"),
                            str(tmp_path / "bare.pth"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, tiny_state[k]), k
    path = save_mmcv(tmp_path / "obj.pth", tiny_state, meta={"hook": NotATensor()})
    with pytest.raises(Exception, match="(?i)weights.only|unpickl|global"):
        load_pretrained(build_model(load_config(TINY).model, device="cpu"), path)


def test_skipped_kinds_name_their_modules():
    """A skipped key's kind depends on the module that would own it."""
    model = build_model(load_config(TINY).model, device="cpu")
    modules = dict(model.named_modules())
    assert skipped_kind(model, modules, "backbone.bn1.num_batches_tracked") == (
        "num_batches_tracked")
    assert skipped_kind(model, modules, "bbox_head.rel_cls_embed.num_batches_tracked") is None
    assert skipped_kind(model, modules, "rpn_head.rpn_conv.weight") is None
