"""The port's box-only datasets and CLIs on the box Pair-Net against
``pairnet_tpu``:

* ``SceneGraphDataset`` and ``OIV6Dataset`` on the synthetic fixture read
  as a box-only split in VG's schema (no segments, no panoptic PNGs): the
  same items, annotations, box masks and images as JAX's classes;
* ``python -m pairnet_torch.tools.test`` on a tiny box Pair-Net (the VG
  config with tiny widths) against JAX's scoring path for the head
  (``evaluate_model_with_postprocess``, as its ``tools/test.py`` routes a
  non-Pair-Net head) on the same weights: equal sgdet metrics with
  ``detection_method="bbox"`` and equal saved predictions; and both
  runners on outputs planted from the split's ground truth, where recall is
  above 0;
* ``python -m pairnet_torch.tools.train`` for 2 steps with the Pair-Net
  losses and with ``detection_only``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.data import sg as j_sg
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.models.heads import pairnet_bbox_head as jb
from pairnet_tpu.train import builder as j_builder
from test_torch_helpers import keep_torch_rng, numpy_init, perturb  # noqa: F401

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.data import sg  # noqa: E402
from pairnet_torch.data.pipeline import Loader  # noqa: E402
from pairnet_torch.evaluation import runner  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.models.heads import pairnet_bbox_head as pb  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = {"num_images": 8, "num_test": 3, "seed": 1}
TINY = f"""
_base_ = ["{os.path.join(REPO, "configs", "deformable_detr", "pairnet_r101_vg.py")}"]
num_object_classes = 7
num_relation_classes = 5
model = dict(backbone=dict(depth=26, base_width=8),
             bbox_head=dict(num_classes=7, num_relations=5, num_obj_query=16, num_rel_query=12,
                            embed_dims=32, num_heads=4, num_encoder_layers=1,
                            num_decoder_layers=2, num_relation_layers=1, ffn_channels=64,
                            relation_ffn_channels=64))
data = dict(
    dataset=dict(type="SceneGraphDataset", ann_file="vg150.json", data_root="",
                 synthetic={SPLIT!r}),
    pipeline=dict(target_size=(96, 128), size_divisor=32, mask_stride=4, max_inst=8,
                  max_rels=10, flip_prob=0.0),
    samples_per_device=2,
)
optimizer = dict(lr=1e-3)
schedule = dict(decay_epochs=[100], max_epochs=2)
evaluation = dict(metric="sgdet", num_things=4, iou_thr=0.5, detection_method="bbox")
"""
TIMING = ("_eval_time_s", "_images_per_s")


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    path = tmp_path_factory.mktemp("configs") / "tiny_bbox_vg.py"
    path.write_text(TINY)
    return str(path)


def _jax_dataset(cls_name, data_root, split):
    """JAX's box-only dataset on the port's box-only split (its native
    preprocessing library loaded first, as ``test_torch_helpers.jax_dataset``
    explains)."""
    from pairnet_tpu import native

    assert native.available()
    return getattr(j_sg, cls_name)("vg150.json", data_root=data_root, split=split)


@pytest.mark.parametrize("cls_name", ["SceneGraphDataset", "OIV6Dataset"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_box_datasets_match_jax(config, cls_name, split):
    """The same items, annotation info (boxes, labels, deduplicated
    relations, relation map, pseudo-segments), box masks and images."""
    cfg = load_config(config).merge({"data": {"dataset": {"type": cls_name}}})
    ds = build_dataset(cfg, split)
    assert type(ds).__name__ == cls_name and ds.detection_method == "bbox"
    jds = _jax_dataset(cls_name, ds.img_prefix, split)
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        assert ds.data[i].pan_seg_file_name == "" and ds.data[i].segments_info == []
        a, b = ds.get_ann_info(i), jds.get_ann_info(i)
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
        for x, y in zip(ds.load_masks(i), jds.load_masks(i)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ds.load_image(i), jds.load_image(i))


@pytest.fixture(scope="module")
def scored(config, tmp_path_factory):
    """(port metrics, JAX metrics, port predictions, JAX predictions) of
    sgdet on the same seeded weights, carried into a port checkpoint."""
    cfg = j_load_config(config)
    jm = j_builder.build_detector(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3)))
    variables = perturb(numpy_init(shapes, 3), seed=4, std=0.05)
    work = tmp_path_factory.mktemp("work")
    (work / "ckpts").mkdir()
    from pairnet_torch.utils.from_jax import load_jax_variables

    port = load_jax_variables(build_model(load_config(config).model, device="cpu"), variables)
    torch.save({"epoch": 1, "state": {"model": port.state_dict()}}, work / "ckpts" / "epoch_1.pt")
    t_sgdet = test_cli.main([config, str(work), "--device", "cpu", "--dtype", "f32",
                             "--batch-size", "3", "--eval", "sgdet",
                             "--save-results", str(work / "port.pkl")])

    tds = build_dataset(load_config(config), "test")
    dataset = _jax_dataset("SceneGraphDataset", tds.img_prefix, "test")
    pipe_cfg = j_builder.build_pipeline_cfg(cfg, train=False)
    fwd = jax.jit(jm.apply)
    j_sgdet = j_runner.evaluate_model_with_postprocess(
        lambda img: fwd(variables, jnp.asarray(img, jnp.float32)), jb.pairnet_bbox_postprocess,
        dataset, pipe_cfg, batch_size=3, mode="sgdet", num_predicates=5, num_things=4,
        iou_thr=0.5, results_out=str(work / "jax.pkl"))
    preds = []
    for who in ("port", "jax"):
        with open(work / f"{who}.pkl", "rb") as f:
            preds.append(pickle.load(f))
    return t_sgdet, j_sgdet, *preds


def _strip(metrics):
    return {k: v for k, v in metrics.items() if not k.endswith(TIMING)}


def test_test_cli_sgdet_matches_jax(scored):
    t, j, _, _ = scored
    assert {"sgdet_eval_time_s", "sgdet_images_per_s"} <= set(t)
    assert _strip(t) == j


def test_test_cli_box_predictions_match_jax(scored):
    """The pickled per-image predictions: labels and pairs equal, boxes at
    the original resolution within 1e-3 px, predicate distributions within
    1e-3 (float16 in the pickle); no masks."""
    _, _, tp, jp = scored
    assert len(tp) == len(jp) == SPLIT["num_test"]
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_array_equal(t["rel_pair_idxes"], j["rel_pair_idxes"])
        np.testing.assert_allclose(t["boxes"], j["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(t["rel_dists"].astype(np.float32),
                                   j["rel_dists"].astype(np.float32), atol=1e-3, rtol=0)
        assert "masks_packed" not in t and "masks_packed" not in j


def _planted(dataset, pipe_cfg, batch_size, K=12, C=7, R=5, seed=7):
    """Head outputs planted from the ground truth of every batch: relation
    slot k < the image's relations holds its GT triplet (the GT boxes, on
    the padded canvas, as cxcywh; class and predicate logits of 8 at the
    GT labels), the other slots noise."""
    rng = np.random.default_rng(seed)
    outs = []
    for batch in Loader(dataset, pipe_cfg, batch_size):
        B = batch["image"].shape[0]
        ph, pw = batch["image"].shape[1:3]
        o = {"sub": rng.normal(size=(B, K, C)), "obj": rng.normal(size=(B, K, C)),
             "rel": rng.normal(size=(B, K, R)), "sub_box": rng.uniform(0.2, 0.6, (B, K, 4)),
             "obj_box": rng.uniform(0.2, 0.6, (B, K, 4))}
        for b in range(B):
            rels = batch["gt_rels"][b][batch["rel_valid"][b]][:K]
            boxes = batch["gt_boxes"][b] / np.array([pw, ph, pw, ph], np.float32)
            cc = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2,
                           boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], -1)
            for k, (s, ob, p) in enumerate(rels):
                o["sub"][b, k, batch["gt_labels"][b, s]] = 8.0
                o["obj"][b, k, batch["gt_labels"][b, ob]] = 8.0
                o["rel"][b, k, p - 1] = 8.0
                o["sub_box"][b, k], o["obj_box"][b, k] = cc[s], cc[ob]
        outs.append({k: v.astype(np.float32) for k, v in o.items()})
    return outs


def test_planted_box_scoring_matches_jax(config):
    """Both runners on outputs planted from the test split's ground truth:
    equal bbox metrics, recall above 0."""
    cfg = load_config(config)
    tds = build_dataset(cfg, "test")
    jds = _jax_dataset("SceneGraphDataset", tds.img_prefix, "test")
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    outs = _planted(tds, pipe_cfg, 2)
    it_t, it_j = iter(outs), iter(outs)
    kw = dict(batch_size=2, num_predicates=5, num_things=4, iou_thr=0.5)
    got = runner.evaluate_model_with_postprocess(
        lambda img: {k: torch.tensor(v) for k, v in next(it_t).items()},
        pb.pairnet_bbox_postprocess, tds, pipe_cfg, **kw)
    want = j_runner.evaluate_model_with_postprocess(
        lambda img: {k: jnp.asarray(v) for k, v in next(it_j).items()},
        jb.pairnet_bbox_postprocess, jds, pipe_cfg, **kw)
    assert got == want
    assert got["sgdet_recall_R@100"] > 0


@pytest.mark.parametrize("detection_only", [False, True], ids=["pairnet", "detection_only"])
def test_train_cli_trains_two_steps(config, tmp_path, detection_only):
    """``--max-steps 2`` (5 train images: 2 batches of 2) with the Pair-Net
    losses (Seesaw counts grow) or the detection-only losses (the decoder
    layers' and the proposals' focal, L1 and gIoU terms; no counts)."""
    args = [config, "--device", "cpu", "--work-dir", str(tmp_path / "work"), "--max-steps", "2"]
    if detection_only:
        args += ["--cfg-options", "loss.detection_only=True"]
    out = train_cli.main(args)
    assert (out["start_epoch"], out["max_epochs"], out["steps"]) == (0, 1, 2)
    assert all(np.isfinite(v) for v in out["last"].values())
    ck = torch.load(tmp_path / "work" / "ckpts" / "epoch_1.pt", map_location="cpu",
                    weights_only=False)["state"]
    if detection_only:
        assert {"loss_cls", "d0.loss_bbox", "enc.loss_iou"} <= set(out["last"])
        assert float(ck["cum_samples"].abs().sum()) == 0.0
    else:
        assert {"loss_r_cls", "loss_sub_cls", "loss_obj_cls", "loss_match"} <= set(out["last"])
        assert ck["cum_samples"].shape == (5,) and float(ck["cum_samples"].sum()) > 0
