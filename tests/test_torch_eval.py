"""Port parity: the evaluation layer of ``pairnet_torch`` (on-device sgdet
recall engine, canvas mask resize, metric accumulator, split-level sgdet and
PQ runners) against the JAX package, and the port's device engine against
its numpy oracle. Head outputs are planted from the ground truth so that
recall and PQ are neither 0 nor trivially perfect."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.evaluation import device_eval as j_dev
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.models.heads.pairnet_inference import pairnet_postprocess as j_post
from test_torch_helpers import TINY_SPLIT, jax_dataset
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.data.pipeline import Loader  # noqa: E402
from pairnet_torch.evaluation import device_eval, runner  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess  # noqa: E402
from pairnet_torch.train.builder import (  # noqa: E402
    build_dataset,
    build_pipeline_cfg,
    synthetic_root,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
NUM_CLASSES, NUM_PREDICATES, NUM_THINGS = 7, 5, 4


def _single_case(seed):
    """GT and predictions for one image: (G=6, R=8) GT; (M=12, K=10)
    predictions, half of the pairs copying a GT relation's labels,
    predicate and (slightly eroded) masks."""
    rng = np.random.default_rng(seed)
    H, W, G, R, M, K = 20, 24, 6, 8, 12, 10
    gt_masks = np.zeros((G, H, W), bool)
    for g in range(G):
        y, x = rng.integers(0, H - 6), rng.integers(0, W - 6)
        gt_masks[g, y : y + rng.integers(4, 7), x : x + rng.integers(4, 7)] = True
    gt_labels = rng.integers(1, NUM_CLASSES + 1, G)
    gt_labels[-1] = 0  # a padded instance
    gt_rels = np.stack([rng.integers(0, G - 1, R), rng.integers(0, G - 1, R),
                        rng.integers(1, NUM_PREDICATES + 1, R)], -1)
    gt_rels[-2:, 2] = 0  # padded relations
    pred_labels = rng.integers(1, NUM_CLASSES + 1, M)
    pred_masks = rng.uniform(size=(M, H, W)) < 0.3
    pred_pairs = rng.integers(0, M, (K, 2))
    dists = rng.uniform(size=(K, NUM_PREDICATES + 1))
    for i in range(0, K, 2):
        s, o, p = gt_rels[i % (R - 2)]
        a, b = 2 * (i // 2) % M, (2 * (i // 2) + 1) % M
        pred_pairs[i] = (a, b)
        pred_labels[a], pred_labels[b] = gt_labels[s], gt_labels[o]
        pred_masks[a], pred_masks[b] = gt_masks[s], gt_masks[o]
        pred_masks[a, rng.integers(0, H), :] = False  # erode by a row: IoU stays high
        dists[i, p] = 2.0
    return gt_labels, gt_rels, gt_masks, pred_labels, pred_pairs, dists.astype(np.float32), pred_masks


@pytest.mark.parametrize("phrdet", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_eval_single_matches_jax(phrdet, seed):
    case = _single_case(seed)
    ref = j_dev.device_eval_single(*(jnp.asarray(a) for a in case), 0.5, (2, 5, 100),
                                   phrdet=phrdet)
    out = device_eval.device_eval_single(*(torch.tensor(a) for a in case), 0.5, (2, 5, 100),
                                         phrdet=phrdet)
    assert len(out) == len(ref) == (3 if phrdet else 2)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    matched = out[0].numpy()
    assert matched[-1].any() and not matched[-1].all()  # planted hits, and misses


@pytest.mark.parametrize("ch, cw, oh, ow", [(24, 32, 96, 128), (13, 21, 50, 83),
                                            (7, 9, 7, 9), (30, 17, 41, 29)])
def test_canvas_resize_matches_jax(ch, cw, oh, ow):
    """Float canvas within 1e-6; thresholded at 0.5 equal wherever the
    value is more than 1e-5 from the threshold."""
    rng = np.random.default_rng(ch)
    masks = (rng.uniform(size=(5, 32, 40)) < 0.5).astype(np.float32)
    ref = np.asarray(j_runner._canvas_resize(jnp.asarray(masks), ch, cw, oh, ow, (56, 136)))
    out = runner.canvas_resize(torch.tensor(masks), ch, cw, oh, ow, (56, 136)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    clear = np.abs(ref - 0.5) > 1e-5
    np.testing.assert_array_equal((out > 0.5)[clear], (ref > 0.5)[clear])
    assert clear.mean() > 0.9


def test_accumulator_summarize_matches_jax():
    rng = np.random.default_rng(3)
    topks = (20, 50, 100)
    j_acc = j_dev.SgdetAccumulator(NUM_PREDICATES, NUM_THINGS, topks)
    acc = device_eval.SgdetAccumulator(NUM_PREDICATES, NUM_THINGS, topks)
    for i in range(7):
        R, G = 9, 6
        labels = rng.integers(1, NUM_CLASSES + 1, G)
        rels = np.stack([rng.integers(0, G, R), rng.integers(0, G, R),
                         rng.integers(0 if i else 1, NUM_PREDICATES + 1, R)], -1)
        if i == 3:
            rels[:, 2] = 0  # an image without relations: skipped by both
        valid = rels[:, 2] > 0
        matched = np.cumsum(rng.uniform(size=(3, R)) < 0.3, axis=0) > 0
        phr = matched | (rng.uniform(size=(3, R)) < 0.2)
        j_acc.add(matched, phr, valid, rels, labels)
        acc.add(torch.tensor(matched), torch.tensor(phr), torch.tensor(valid), rels, labels)
    ref = j_acc.summarize("sgdet")
    out = acc.summarize("sgdet")
    assert out == ref
    assert 0 < out["sgdet_recall_R@20"] < 1


def _datasets(split="test"):
    """The port's tiny_synthetic split, and JAX's reader on the same files."""
    return (build_dataset(load_config(TINY), split),
            jax_dataset(synthetic_root(TINY_SPLIT), split))


def _oracle_outputs(dataset, pipe_cfg, batch_size, seed=0):
    """Per batch, head outputs planted from the batch's ground truth: two of
    every three GT relations as a pair with the GT labels, predicate and
    masks (+-8 logits), the rest random; the fusion queries carry the GT
    segments, with every fourth one dropped."""
    rng = np.random.default_rng(seed)
    K, Q = 10, 8
    C1 = NUM_CLASSES + 1
    outs = []
    for batch in Loader(dataset, pipe_cfg, batch_size):
        B, G, h4, w4 = batch["gt_masks"].shape
        out = {
            "sub": rng.normal(size=(B, K, C1)), "obj": rng.normal(size=(B, K, C1)),
            "rel": rng.normal(size=(B, K, NUM_PREDICATES)),
            "sub_seg": rng.normal(size=(B, K, h4, w4)) - 4,
            "obj_seg": rng.normal(size=(B, K, h4, w4)) - 4,
            "cls": rng.normal(size=(B, Q, C1)), "mask": rng.normal(size=(B, Q, h4, w4)),
        }
        for b in range(B):
            gm, gl = batch["gt_masks"][b], batch["gt_labels"][b]
            rels = batch["gt_rels"][b][batch["rel_valid"][b]]
            for i, (s, o, p) in enumerate(rels[:K]):
                if i % 3 == 2:
                    continue
                out["sub"][b, i, gl[s]] += 10
                out["obj"][b, i, gl[o]] += 10
                out["rel"][b, i, p - 1] += 10
                out["sub_seg"][b, i] = np.where(gm[s], 8.0, -8.0)
                out["obj_seg"][b, i] = np.where(gm[o], 8.0, -8.0)
            for q in range(min(Q, int(batch["gt_valid"][b].sum()))):
                if q % 4 == 3:
                    continue
                out["cls"][b, q, gl[q]] += 10
                out["mask"][b, q] = np.where(gm[q], 8.0, -8.0)
        outs.append({k: v.astype(np.float32) for k, v in out.items()})
    return outs


def _apply_fns(outs):
    """(port apply_fn, JAX apply_fn), each handing out the planted outputs
    batch by batch."""
    it_t, it_j = iter(outs), iter(outs)
    return ((lambda img: {k: torch.tensor(v) for k, v in next(it_t).items()}),
            (lambda img: {k: jnp.asarray(v) for k, v in next(it_j).items()}))


KW = dict(batch_size=2, mode="sgdet", num_predicates=NUM_PREDICATES, num_things=NUM_THINGS,
          iou_thr=0.5)


def test_evaluate_model_device_matches_jax():
    """The test split (3 images, batch 2: the last batch padded): the same
    metric dict, key for key and value for value."""
    tds, jds = _datasets()
    pipe_cfg = build_pipeline_cfg(load_config(TINY), train=False)
    apply_t, apply_j = _apply_fns(_oracle_outputs(tds, pipe_cfg, 2))
    out = runner.evaluate_model_device(apply_t, tds, pipe_cfg, **KW)
    ref = j_runner.evaluate_model_device(apply_j, jds, pipe_cfg, **KW)
    assert out == ref
    assert 0 < out["sgdet_recall_R@20"] < 1 and out["phrdet_recall_R@20"] > 0


def test_evaluate_pq_matches_jax():
    tds, jds = _datasets()
    pipe_cfg = build_pipeline_cfg(load_config(TINY), train=False)
    apply_t, apply_j = _apply_fns(_oracle_outputs(tds, pipe_cfg, 2, seed=1))
    out = runner.evaluate_pq(apply_t, pairnet_postprocess, tds, pipe_cfg, batch_size=2,
                             num_classes=NUM_CLASSES, num_things=NUM_THINGS)
    ref = j_runner.evaluate_pq(apply_j, j_post, jds, pipe_cfg, batch_size=2,
                               num_classes=NUM_CLASSES, num_things=NUM_THINGS)
    assert out == ref
    assert 0 < out["All_PQ"] < 100


def test_device_engine_matches_numpy_oracle():
    """The port's two engines on the same planted outputs (train split, 5
    images): the same R@K and mR@K. With +-8 logits and a 4x upsampling,
    PIL's bilinear resize of the logits and the device's of the 0/1 masks
    decide every pixel alike."""
    tds, _ = _datasets("train")
    pipe_cfg = build_pipeline_cfg(load_config(TINY), train=False)
    outs = _oracle_outputs(tds, pipe_cfg, 2, seed=2)
    apply_a, _ = _apply_fns(outs)
    apply_b, _ = _apply_fns(outs)
    dev = runner.evaluate_model_device(apply_a, tds, pipe_cfg, **KW)
    ref = runner.evaluate_model(apply_b, tds, pipe_cfg, **KW)
    for k in (20, 50, 100):
        for key in (f"sgdet_recall_R@{k}", f"sgdet_mean_recall_mR@{k}"):
            assert dev[key] == pytest.approx(ref[key], abs=1e-12), key
    assert 0 < dev["sgdet_recall_R@20"] < 1


@pytest.mark.parametrize("hw,out_hw", [((200, 334), (800, 1333)), ((24, 32), (96, 128)),
                                       ((40, 61), (23, 200)), ((333, 127), (41, 19)),
                                       ((7, 7), (800, 3))])
def test_resize_logits_is_pils_bilinear(hw, out_hw):
    """The numpy oracle's mask upsampling equals PIL's mode-F bilinear
    resize bit for bit, upsampling and downsampling, without PIL."""
    from PIL import Image

    maps = np.random.default_rng(sum(hw)).normal(size=(3, *hw)).astype(np.float32)
    H, W = out_hw
    want = np.stack([np.asarray(Image.fromarray(m, mode="F").resize((W, H), Image.BILINEAR))
                     for m in maps])
    np.testing.assert_array_equal(runner._resize_logits(maps, out_hw), want)
