"""The port's CLIs on the one-stage zoo: ``python -m pairnet_torch.tools.test``
(sgdet through the head's own post-processing and the host oracle, then
PQ, in one process and on 2 gloo ranks) and ``python -m
pairnet_torch.tools.train`` (2 steps, then ``--resume``) on a tiny PSGTr
and a tiny Seesaw baseline, built from the published configs with tiny
widths on the synthetic split; and every zoo loss on 2 ranks against
world 1 (the global normalizers of ``reduce``).

The scoring runs are held against the JAX package's scoring path for these
heads (``evaluate_model_with_postprocess`` and ``evaluate_pq``, as its
``tools/test.py`` routes them) on the same weights, carried into a port
checkpoint: the metric dicts equal, and the saved predictions equal
(labels, pairs, predicate distributions within 1e-3, as they are pickled
in float16; mask bits, which sit behind a sigmoid threshold and a resize,
equal but for a ``MASK_FLIPS`` share). Random weights score 0, so the
runners are also held against JAX's on head outputs planted from the
split's ground truth, where recall and PQ are neither 0 nor perfect.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.train import builder as j_builder
from pairnet_tpu.train.dispatch import get_postprocess_fn as j_post_fn
from pairnet_tpu.models.heads import baseline_head as j_baseline
from pairnet_tpu.models.heads import psgtr_head as j_psgtr
from test_torch_dist import run_ranks, sharded_cli_scoring, zoo_loss_shares
from test_torch_eval import _oracle_outputs
from test_torch_helpers import (
    TINY_SPLIT,
    jax_dataset,
    numpy_init,
    perturb,
    tree_numpy,
    tree_torch,
    zoo_batch,
)
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.evaluation import runner  # noqa: E402
from pairnet_torch.models.heads import baseline_head, psgtr_head  # noqa: E402
from pairnet_torch.models.frameworks.psgtr import build_model  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg  # noqa: E402
from pairnet_torch.train.builder import synthetic_root  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_COMMON = """
num_object_classes = 7
num_relation_classes = 5
data = dict(
    dataset=dict(type="PSGDataset", ann_file="psg.json", data_root="", synthetic=True),
    pipeline=dict(target_size=(96, 128), size_divisor=32, mask_stride=4, max_inst=8,
                  max_rels=10, flip_prob=0.0),
    samples_per_device=2,
)
optimizer = dict(lr=1e-3)
schedule = dict(decay_epochs=[100], max_epochs=2)
evaluation = dict(metric="sgdet", num_things=4, iou_thr=0.5)
"""
TINY = {
    "psgtr": ("psgtr/psgtr_r50_psg.py", """
model = dict(backbone=dict(depth=26, base_width=8),
             bbox_head=dict(num_classes=7, num_relations=5, num_query=12, embed_dims=32,
                            num_heads=4, num_encoder_layers=2, num_decoder_layers=2))
"""),
    "baseline": ("baseline/baseline_seesaw_r50_psg.py", """
model = dict(backbone=dict(depth=26, base_width=8),
             bbox_head=dict(num_classes=7, num_relations=5, num_obj_query=20, num_rel_query=16,
                            embed_dims=32, num_heads=4, num_decoder_layers=3,
                            num_relation_layers=2, pixel_decoder_layers=1))
loss = dict(num_points=256, use_seesaw=True)
"""),
}
MASK_FLIPS = 1e-3
TIMING = ("_eval_time_s", "_images_per_s")


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """Per head: the tiny config file, written beside the published one it
    derives from."""
    root = tmp_path_factory.mktemp("configs")
    paths = {}
    for name, (base, body) in TINY.items():
        path = root / f"tiny_{name}.py"
        path.write_text(f'_base_ = ["{os.path.join(REPO, "configs", base)}"]\n'
                        + TINY_COMMON + body)
        paths[name] = str(path)
    return paths


@pytest.fixture(scope="module")
def scored(configs, tmp_path_factory):
    """Per head: (port metrics, JAX metrics, port predictions, JAX
    predictions) of sgdet, and the two PQ metric dicts."""
    res = {}
    for name, path in configs.items():
        cfg = j_load_config(path)
        jm = j_builder.build_detector(cfg)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        variables = perturb(numpy_init(shapes, 3), seed=4, std=0.05)
        work = tmp_path_factory.mktemp(f"work_{name}")
        (work / "ckpts").mkdir()
        port = load_jax_variables(build_model(load_config(path).model, device="cpu"), variables)
        torch.save({"epoch": 1, "state": {"model": port.state_dict()}},
                   work / "ckpts" / "epoch_1.pt")
        args = [path, str(work), "--device", "cpu", "--dtype", "f32", "--batch-size", "3"]
        t_sgdet = test_cli.main(args + ["--eval", "sgdet", "--save-results",
                                        str(work / "port.pkl")])
        t_pq = test_cli.main(args + ["--eval", "PQ"])

        dataset = jax_dataset(synthetic_root(TINY_SPLIT), "test")
        pipe_cfg = j_builder.build_pipeline_cfg(cfg, train=False)
        fwd = jax.jit(jm.apply)
        apply_fn = lambda img: fwd(variables, jnp.asarray(img, jnp.float32))  # noqa: E731
        post = j_post_fn(cfg.model.bbox_head.type)
        kw = dict(batch_size=3, num_things=cfg.evaluation.num_things)
        j_sgdet = j_runner.evaluate_model_with_postprocess(
            apply_fn, post, dataset, pipe_cfg, mode="sgdet", num_predicates=5,
            iou_thr=0.5, results_out=str(work / "jax.pkl"), **kw)
        j_pq = j_runner.evaluate_pq(apply_fn, post, dataset, pipe_cfg, num_classes=7, **kw)
        preds = []
        for who in ("port", "jax"):
            with open(work / f"{who}.pkl", "rb") as f:
                preds.append(pickle.load(f))
        res[name] = (t_sgdet, j_sgdet, *preds, t_pq, j_pq)
        res[f"{name} args"] = args
    return res


def _strip(metrics):
    return {k: v for k, v in metrics.items() if not k.endswith(TIMING)}


@pytest.mark.parametrize("name", list(TINY))
def test_test_cli_sgdet_matches_jax(scored, name):
    t, j, _, _, _, _ = scored[name]
    assert {"sgdet_eval_time_s", "sgdet_images_per_s"} <= set(t)
    assert _strip(t) == j


@pytest.mark.parametrize("name", list(TINY))
def test_test_cli_pq_matches_jax(scored, name):
    _, _, _, _, t, j = scored[name]
    assert {"PQ_eval_time_s", "PQ_images_per_s"} <= set(t)
    assert _strip(t) == j


@pytest.mark.parametrize("name", list(TINY))
def test_test_cli_predictions_match_jax(scored, name):
    """The pickled per-image predictions of ``--save-results``: labels and
    pairs equal, predicate distributions within 1e-3 (float16 in the
    pickle), mask bits equal but for a MASK_FLIPS share."""
    _, _, tp, jp, _, _ = scored[name]
    assert len(tp) == len(jp) == TINY_SPLIT["num_test"]
    flips = total = 0
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_array_equal(t["rel_pair_idxes"], j["rel_pair_idxes"])
        np.testing.assert_allclose(t["rel_dists"].astype(np.float32),
                                   j["rel_dists"].astype(np.float32), atol=1e-3, rtol=0)
        assert tuple(t["mask_shape"]) == tuple(j["mask_shape"])
        flips += int(np.unpackbits(t["masks_packed"] ^ j["masks_packed"]).sum())
        total += int(np.prod(t["mask_shape"]))
    assert flips <= MASK_FLIPS * total, (flips, total)


def test_test_cli_sharded_equals_one_process(scored, tmp_path):
    """PSGTr scored by the CLI on 2 gloo ranks (the split's 3 test images
    as shards of 2 and 1): the same metrics and the same saved predictions,
    in dataset order, as in one process."""
    args = scored["psgtr args"]
    out = run_ranks(sharded_cli_scoring, 2, tmp_path, args, str(tmp_path / "w2.pkl"), timeout=240)
    t_sgdet, _, tp, _, t_pq, _ = scored["psgtr"]
    for rank in out:
        assert _strip(rank["sgdet"]) == _strip(t_sgdet)
        assert _strip(rank["PQ"]) == _strip(t_pq)
    with open(tmp_path / "w2.pkl", "rb") as f:
        w2 = pickle.load(f)
    assert len(w2) == len(tp)
    for a, b in zip(w2, tp):
        for k in ("labels", "rel_pair_idxes", "rel_dists", "masks_packed"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(TINY))
def test_train_cli_trains_and_resumes(configs, tmp_path, name):
    """``--max-steps 2`` (the split's 5 train images make 2 batches of 2)
    trains epoch 1 with the head's own loss and writes ``epoch_1.pt``;
    ``--resume --max-steps 4`` continues at epoch 1; the Seesaw baseline
    carries R + 1 = 6 counts, grown by the steps."""
    work = tmp_path / "work"
    run = lambda *a: train_cli.main([configs[name], "--device", "cpu",  # noqa: E731
                                     "--work-dir", str(work), *a])
    first = run("--max-steps", "2")
    assert (first["start_epoch"], first["max_epochs"], first["steps"]) == (0, 1, 2)
    assert np.isfinite(first["last"]["loss_total"])
    second = run("--resume", "--max-steps", "4")
    assert (second["start_epoch"], second["max_epochs"], second["steps"]) == (1, 2, 2)
    assert np.isfinite(second["last"]["loss_total"])
    ck1, ck2 = (torch.load(work / "ckpts" / f"epoch_{e}.pt", map_location="cpu",
                           weights_only=False)["state"] for e in (1, 2))
    assert (ck1["step"], ck2["step"]) == (2, 4)
    assert not torch.equal(ck1["model"]["bbox_head.rel_cls_embed.weight"],
                           ck2["model"]["bbox_head.rel_cls_embed.weight"])
    if name == "baseline":
        assert ck2["cum_samples"].shape == (6,)
        assert float(ck2["cum_samples"].sum()) > float(ck1["cum_samples"].sum()) > 0
    else:
        assert float(ck2["cum_samples"].abs().sum()) == 0.0  # PSGTr carries no Seesaw counts


@pytest.mark.parametrize("head", ["psgtr", "baseline"])
def test_planted_scoring_matches_jax(head):
    """The zoo's scoring runners (sgdet through the head's post-processing
    and the host oracle, and PQ) on outputs planted from the ground truth
    of the tiny split's test images (a background column put first in the
    predicate logits, as these heads have): equal to JAX's, recall and PQ
    above 0."""
    cfg = load_config(os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py"))
    tds = build_dataset(cfg, "test")
    jds = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    outs = _oracle_outputs(tds, pipe_cfg, 2, seed=5)
    for o in outs:
        o["rel"] = np.concatenate([np.zeros_like(o["rel"][..., :1]), o["rel"]], -1)
    post_t, post_j = {"psgtr": (psgtr_head.psgtr_postprocess, j_psgtr.psgtr_postprocess),
                      "baseline": (baseline_head.baseline_postprocess,
                                   j_baseline.baseline_postprocess)}[head]
    kw = dict(batch_size=2, num_things=4)
    got, want = {}, {}
    for what in ("sgdet", "PQ"):
        it_t, it_j = iter(outs), iter(outs)
        apply_t = lambda img: {k: torch.tensor(v) for k, v in next(it_t).items()}  # noqa: E731
        apply_j = lambda img: {k: jnp.asarray(v) for k, v in next(it_j).items()}  # noqa: E731
        if what == "sgdet":
            got[what] = runner.evaluate_model_with_postprocess(
                apply_t, post_t, tds, pipe_cfg, num_predicates=5, iou_thr=0.5, **kw)
            want[what] = j_runner.evaluate_model_with_postprocess(
                apply_j, post_j, jds, pipe_cfg, num_predicates=5, iou_thr=0.5, **kw)
        else:
            got[what] = runner.evaluate_pq(apply_t, post_t, tds, pipe_cfg, num_classes=7, **kw)
            want[what] = j_runner.evaluate_pq(apply_j, post_j, jds, pipe_cfg, num_classes=7,
                                              **kw)
    assert got == want
    assert got["sgdet"]["sgdet_recall_R@100"] > 0 and got["PQ"]["All_PQ"] > 0


ZOO_HEADS = {  # head type -> (port head kwargs, loss config)
    "PSGTrHead": (dict(num_classes=7, num_relations=5, num_query=12, embed_dims=32, num_heads=4,
                       num_encoder_layers=2, num_decoder_layers=2), {"num_classes": 7}),
    "PSGFormerHead": (dict(num_classes=7, num_relations=5, num_obj_query=12, num_rel_query=10,
                           embed_dims=32, num_heads=4, num_encoder_layers=2,
                           num_decoder_layers=2), {"num_classes": 7}),
    "BaselineHead": (dict(num_classes=7, num_relations=5, num_obj_query=20, num_rel_query=16,
                          embed_dims=32, num_heads=4, num_decoder_layers=3,
                          num_relation_layers=2, pixel_decoder_layers=1),
                     {"num_points": 64, "use_seesaw": True}),
    "PSGTr2Head": (dict(num_classes=7, num_relations=5, num_query=12, embed_dims=32,
                        num_heads=4, num_decoder_layers=3, pixel_decoder_layers=1),
                   {"num_points": 64, "num_classes": 7}),
    "Detr4SegHead": (dict(num_classes=7, num_query=12, embed_dims=32, num_heads=4,
                          num_encoder_layers=2, num_decoder_layers=2),
                     {"num_points": 64, "num_classes": 7}),
}


def test_losses_sum_to_world_one_on_two_ranks(tmp_path):
    """Every one-stage head's loss on 2 gloo ranks, one image each, with
    ``reduce`` (every normalizer global): the ranks' losses sum to the
    world-1 loss of both images within 1e-5, and the Seesaw counts are the
    world-1 counts on both ranks."""
    from pairnet_torch.flagship import init_weights
    from pairnet_torch.models.backbones.resnet import ResNet
    from pairnet_torch.models.frameworks.psgtr import PSGTr, _heads
    from pairnet_torch.train.dispatch import get_loss_fn

    batch = zoo_batch(seed=3)
    images = batch.pop("image")
    rng = np.random.default_rng(5)
    cases, want = {}, {}
    for head, (kw, cfg) in ZOO_HEADS.items():
        bb = ResNet(depth=26, base_width=8)
        model = init_weights(PSGTr(bb, *_heads()[head](bb.out_channels, **kw)), seed=1).eval()
        with torch.no_grad():
            out = tree_numpy(model(torch.tensor(images)))
        out = {k: v for k, v in out.items() if k not in ("sub_pos", "obj_pos")}
        points = rng.uniform(size=(2, cfg.get("num_points", 0), 2)).astype(np.float32)
        cum = np.arange(6 if cfg.get("use_seesaw") else 5, dtype=np.float32)
        cases[head] = (cfg, out, batch, points, cum)
        losses, new_cum = get_loss_fn(head, {"loss": cfg})(
            tree_torch(out), tree_torch(batch), torch.tensor(points), torch.tensor(cum))
        want[head] = ({k: float(v) for k, v in losses.items()}, new_cum.numpy())
    ranks = run_ranks(zoo_loss_shares, 2, tmp_path, cases, timeout=240)
    for head, (w, w_cum) in want.items():
        for k, v in w.items():
            got = sum(r[head][0][k] for r in ranks)
            assert abs(got - v) <= 1e-5 * max(1.0, abs(v)), (head, k, got, v)
        for r in ranks:
            np.testing.assert_allclose(r[head][1], w_cum, rtol=0, atol=0)
    assert (want["BaselineHead"][1] > cases["BaselineHead"][4]).any()
