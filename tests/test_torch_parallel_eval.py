"""Sharded scoring on 2 gloo ranks: the port's three scoring runners and its
scoring CLI over the tiny_synthetic train split (5 images, so the shards
are uneven: images 0, 2, 4 and 1, 3) against the same at world size 1 and
against the JAX package's ``evaluate_model_device`` and ``evaluate_pq``,
within 1e-6; and the exact merge of the sgdet bucket statistics (as
``tests/test_multidevice_eval.py`` checks JAX's)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.evaluation import device_eval as j_dev
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.models.heads.pairnet_inference import pairnet_postprocess as j_post
from test_torch_dist import Ranks, image_key, planted_apply, sharded_scoring
from test_torch_eval import _oracle_outputs
from test_torch_helpers import TINY_SPLIT, jax_dataset
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.data.pipeline import Loader  # noqa: E402
from pairnet_torch.data.sg import shard  # noqa: E402
from pairnet_torch.evaluation import device_eval, runner  # noqa: E402
from pairnet_torch.evaluation.runner import load_predictions  # noqa: E402
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.train.builder import (  # noqa: E402
    build_dataset,
    build_pipeline_cfg,
    synthetic_root,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
KW = dict(batch_size=2, mode="sgdet", num_predicates=5, num_things=4, iou_thr=0.5)
CLI = [TINY, "--device", "cpu", "--dtype", "f32", "--split", "train", "--batch-size", "1"]
TIMED = ("_eval_time_s", "_images_per_s")


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Planted outputs for each train image; the world-2 runs (spawned
    first), the world-1 runs and JAX's."""
    tmp = tmp_path_factory.mktemp("scoring")
    cfg = load_config(TINY)
    dataset = build_dataset(cfg, "train")
    assert len(dataset) == 5
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    # each image's outputs planted from its own GT (batch 1, in dataset order)
    outs = _oracle_outputs(dataset, pipe_cfg, 1, seed=4)
    keys = [image_key(b["image"][0]) for b in Loader(dataset, pipe_cfg, 1)]
    planted = dict(zip(keys, outs))
    assert len(planted) == 5
    ranks = Ranks(sharded_scoring, 2, tmp, TINY, "train", planted, KW, str(tmp / "w2.pkl"),
                  CLI, timeout=240)
    apply_fn = planted_apply(planted)
    w1 = {"sgdet": runner.evaluate_model_device(apply_fn, dataset, pipe_cfg, **KW),
          "pq": runner.evaluate_pq(apply_fn, pairnet_postprocess, dataset, pipe_cfg,
                                   batch_size=2, num_classes=7, num_things=4),
          "oracle": runner.evaluate_model(apply_fn, dataset, pipe_cfg,
                                          results_out=str(tmp / "w1.pkl"), **KW)}
    for ev in ("sgdet", "PQ"):
        w1[f"cli_{ev}"] = test_cli.main(CLI + ["--eval", ev])

    def apply_j(images):
        outs = [planted[image_key(img)] for img in images]
        return {k: jnp.asarray(np.concatenate([o[k] for o in outs])) for k in outs[0]}

    jds = jax_dataset(synthetic_root(TINY_SPLIT), "train")
    jax_ref = {"sgdet": j_runner.evaluate_model_device(apply_j, jds, pipe_cfg, **KW),
               "pq": j_runner.evaluate_pq(apply_j, j_post, jds, pipe_cfg, batch_size=2,
                                          num_classes=7, num_things=4)}
    return {"ranks": ranks.join(), "w1": w1, "jax": jax_ref, "tmp": tmp}


def _close(got, want, what):
    got = {k: v for k, v in got.items() if not k.endswith(TIMED)}
    want = {k: v for k, v in want.items() if not k.endswith(TIMED)}
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("engine", ["sgdet", "pq", "oracle", "cli_sgdet", "cli_PQ"])
def test_sharded_scoring_equals_world1(scored, engine):
    """Both ranks return the same metrics, equal to world 1's; the planted
    outputs score above 0."""
    a, b = (r[engine] for r in scored["ranks"])
    _close(a, b, f"rank 1 vs rank 0, {engine}")
    _close(a, scored["w1"][engine], f"world 2 vs world 1, {engine}")
    if not engine.startswith("cli"):
        assert max(v for k, v in a.items() if not k.endswith(TIMED)) > 0


@pytest.mark.parametrize("engine", ["sgdet", "pq"])
def test_sharded_scoring_equals_jax(scored, engine):
    _close(scored["ranks"][0][engine], scored["jax"][engine], f"world 2 vs JAX, {engine}")
    assert "phrdet_recall_R@50" in scored["ranks"][0]["sgdet"]


def test_sharded_oracle_saves_dataset_order(scored):
    """Rank 0 writes the gathered predictions in dataset order: the world-1
    pickle, entry for entry."""
    w1 = load_predictions(str(scored["tmp"] / "w1.pkl"))
    w2 = load_predictions(str(scored["tmp"] / "w2.pkl"))
    assert len(w1) == len(w2) == 5
    for p, q in zip(w1, w2):
        np.testing.assert_array_equal(p.labels, q.labels)
        np.testing.assert_array_equal(p.rel_dists, q.rel_dists)
        np.testing.assert_array_equal(p.masks, q.masks)


def test_shards_are_disjoint_and_complete():
    dataset = build_dataset(load_config(TINY), "train")
    shards = [shard(dataset, r, 2) for r in range(2)]
    assert [s.indices for s in shards] == [[0, 2, 4], [1, 3]]
    assert shard(dataset, 0, 1) is dataset
    for r, s in enumerate(shards):
        for i, idx in enumerate(s.indices):
            assert s.get_ann_info(i)["seg_map"] == dataset.get_ann_info(idx)["seg_map"]
    assert [len(shard(dataset, r, 7)) for r in range(7)] == [1, 1, 1, 1, 1, 0, 0]


def test_bucket_stats_merge_exactly():
    """The (sum, count) buckets of images split over 3 accumulators, summed,
    give the metrics of one accumulator over all of them, and JAX's."""
    rng = np.random.default_rng(7)
    T = (20, 50, 100)

    def rand_image():
        R = int(rng.integers(1, 6))
        matched = rng.random((3, R)) < 0.5
        phr = matched | (rng.random((3, R)) < 0.3)
        rels = np.stack([rng.integers(0, 4, R), rng.integers(0, 4, R),
                         rng.integers(1, 6, R)], -1)
        return matched, phr, np.ones(R, bool), rels, rng.integers(1, 8, 4)

    images = [rand_image() for _ in range(12)]
    whole = device_eval.SgdetAccumulator(5, num_things=4, topks=T)
    j_whole = j_dev.SgdetAccumulator(5, num_things=4, topks=T)
    parts = [device_eval.SgdetAccumulator(5, num_things=4, topks=T) for _ in range(3)]
    for i, img in enumerate(images):
        whole.add(*img)
        j_whole.add(*img)
        parts[i % 3].add(*img)
    ref = whole.summarize("sgdet")
    assert ref == j_whole.summarize("sgdet")
    stats = [p.bucket_stats() for p in parts]
    merged = {k: np.sum([s[k] for s in stats], axis=0) for k in stats[0]}
    got = whole.metrics(merged, "sgdet")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-9, err_msg=k)
