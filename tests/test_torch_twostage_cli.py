"""Port parity of the two-stage data path and CLIs against the JAX package.

* ``to_twostage_batch`` through the port's ``Loader`` (one sequential
  stream, and per-sample streams on two threads) against JAX's: every
  array equal, train pairs and test pairs.
* ``python -m pairnet_torch.tools.test`` on a tiny MOTIFS config (ResNet-26
  at base width 8, hidden 32, roi 64, 96 x 128, ``max_inst`` 8, the
  synthetic split's 7 classes and 5 predicates) against JAX's
  ``tools/test.py``: JAX's CLI scores seeded variables from an orbax
  checkpoint (predcls, the numpy oracle); the same variables, in a port
  checkpoint, are scored by the port's CLI, and predcls and sgcls on both
  engines give JAX's metrics (JAX's other runs reuse its CLI's forward
  through ``evaluate_twostage``); sgdet runs through the tiny detector and
  gives JAX's sgdet key set, finite; PQ exits as JAX's does. The MOTIFS
  sgcls and sgdet heads raise on GT-box batches (no ``det_dists``). On 2
  gloo ranks the CLI scores shards and every rank gets JAX's metrics.
* ``python -m pairnet_torch.tools.train`` for 2 steps, then ``--resume``.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest

from pairnet_tpu.config import apply_overrides as j_apply_overrides
from pairnet_tpu.config import load_config as j_load_config
from pairnet_tpu.data.pipeline import Loader as JLoader
from pairnet_tpu.data.pipeline import to_twostage_batch as j_to_twostage_batch
from pairnet_tpu.evaluation import runner as j_runner
from pairnet_tpu.evaluation.sgg_eval import SGGroundTruth, SGPrediction
from pairnet_tpu.evaluation.sgg_eval import sgg_evaluate as j_sgg_evaluate
from pairnet_tpu.train import builder as j_builder
from test_torch_dist import run_ranks, twostage_cli_scoring
from test_torch_helpers import TINY_SPLIT, jax_dataset, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import apply_overrides, load_config  # noqa: E402
from pairnet_torch.data.pipeline import Loader, to_twostage_batch  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train.builder import build_dataset, build_model, build_pipeline_cfg  # noqa: E402
from pairnet_torch.train.builder import synthetic_root  # noqa: E402
from pairnet_torch.utils.from_jax import load_jax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "motifs", "panoptic_fpn_r50_predcls_psg.py")
TINY = ["data.pipeline.target_size=(96,128)", "data.pipeline.max_inst=8",
        "model.backbone.depth=26", "model.backbone.base_width=8",
        "model.relation_head.hidden_dim=32", "model.relation_head.roi_dim=64",
        "model.relation_head.context_pooling_dim=96", "model.relation_head.embed_dim=16",
        "model.relation_head.num_classes=8", "model.relation_head.num_predicates=6",
        "num_object_classes=7", "num_relation_classes=5", "evaluation.num_things=4",
        "data.samples_per_device=2"]
DETECTOR = ["model.detector.type=PanopticFPN", "model.detector.backbone.type=ResNet",
            "model.detector.backbone.depth=26", "model.detector.backbone.base_width=8",
            "model.detector.num_proposals=32", "model.detector.num_things=4",
            "model.detector.num_stuff=3", "model.detector.score_thr=0.05"]


def tiny_options():
    """The tiny config's overrides, reading the port's 8-image synthetic
    split (the same files for both packages)."""
    root = synthetic_root(TINY_SPLIT)
    return [f"data.dataset.data_root={root}", "data.dataset.synthetic=False", *TINY]


@pytest.mark.parametrize("num_workers", [0, 2], ids=["one_stream", "per_sample_rngs"])
@pytest.mark.parametrize("train", [True, False], ids=["train_pairs", "test_pairs"])
def test_twostage_batches_equal_jax(num_workers, train):
    opts = tiny_options()
    jcfg = j_apply_overrides(j_load_config(CONFIG), opts)
    tcfg = apply_overrides(load_config(CONFIG), opts)
    jds = jax_dataset(synthetic_root(TINY_SPLIT), "train")
    tds = build_dataset(tcfg, "train")
    max_pairs = 16 if train else 56
    jl = JLoader(jds, j_builder.build_pipeline_cfg(jcfg, train=train), 2, train=train, seed=3,
                 num_workers=num_workers,
                 sample_transform=lambda s, rng: j_to_twostage_batch(s, max_pairs, train, rng))
    tl = Loader(tds, build_pipeline_cfg(tcfg, train=train), 2, train=train, seed=3,
                num_workers=num_workers,
                sample_transform=lambda s, rng: to_twostage_batch(s, max_pairs, train, rng))
    n = 0
    for jb, tb in zip(jl, tl, strict=True):
        assert set(jb) == set(tb)
        assert tb["pair_valid"].any() and (tb["pair_labels"] > 0).any()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        n += 1
    assert n == len(tds) // 2 if train else -(-len(tds) // 2)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """JAX's CLI on the tiny config (predcls, numpy engine) with its metrics
    and variables, its other runs through JAX's ``evaluate_twostage`` on
    the CLI's forward, and a port work dir holding those variables."""
    opts = tiny_options()
    jcfg = j_apply_overrides(j_load_config(CONFIG), opts)
    dataset = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    pipe_cfg = j_builder.build_pipeline_cfg(jcfg, train=False)
    # seeded variables of JAX's model, in an orbax checkpoint that JAX's CLI restores
    jm = j_builder.build_detector(jcfg)
    init_batch = {k: jnp.asarray(v) for k, v in next(iter(JLoader(
        dataset, pipe_cfg, 1, train=False, seed=0, sample_transform=lambda s, rng:
        j_to_twostage_batch(s, 56, train=False, rng=rng)))).items()}
    variables = jax.tree_util.tree_map(np.asarray, perturb(
        jax.jit(jm.init)(jax.random.PRNGKey(0), init_batch), seed=1, std=0.05))
    jwork = tmp_path_factory.mktemp("jax")
    mgr = ocp.CheckpointManager(str(jwork / "ckpts"))
    mgr.save(1, args=ocp.args.StandardSave({"params": variables}))
    mgr.wait_until_finished()

    out = jwork / "predcls.json"
    captured = {}
    argv = sys.argv
    sys.argv = ["tools/test.py", CONFIG, str(jwork), "--eval", "predcls", "--eval-engine",
                "numpy", "--out", str(out), "--batch-size", "2", "--cfg-options", *opts]
    orig_evaluate = j_runner.evaluate_twostage

    def capturing(apply_fn, *args, **kw):
        captured["apply"] = apply_fn
        return orig_evaluate(apply_fn, *args, **kw)

    j_runner.evaluate_twostage = capturing
    try:
        runpy.run_path(os.path.join(REPO, "tools", "test.py"), run_name="__main__")
    finally:
        sys.argv = argv
        j_runner.evaluate_twostage = orig_evaluate
    metrics = {"predcls-numpy": json.loads(out.read_text())}
    for mode, engine in (("predcls", "device"), ("sgcls", "numpy"), ("sgcls", "device")):
        metrics[f"{mode}-{engine}"] = j_runner.evaluate_twostage(
            captured["apply"], dataset, pipe_cfg, batch_size=2, mode=mode,
            num_predicates=jcfg.num_relation_classes, num_things=jcfg.evaluation.num_things,
            eval_engine=engine)
    work = tmp_path_factory.mktemp("work")
    (work / "ckpts").mkdir()
    port = load_jax_variables(build_model(apply_overrides(load_config(CONFIG), opts).model,
                                          device="cpu"), variables)
    torch.save({"epoch": 1, "state": {"model": port.state_dict()}}, work / "ckpts" / "epoch_1.pt")
    return metrics, work, opts


@pytest.mark.parametrize("mode, engine", [("predcls", "numpy"), ("predcls", "device"),
                                          ("sgcls", "numpy"), ("sgcls", "device")])
def test_scoring_cli_matches_jax(scored, mode, engine):
    metrics, work, opts = scored
    want = metrics[f"{mode}-{engine}"]
    got = test_cli.main([CONFIG, str(work), "--device", "cpu", "--eval", mode, "--eval-engine",
                         engine, "--batch-size", "2", "--cfg-options", *opts])
    timing = {f"{mode}_eval_time_s", f"{mode}_images_per_s"}
    want = {k: v for k, v in want.items() if k not in timing}
    assert set(got) - timing == set(want)
    assert any(v > 0 for v in want.values())
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_sharded_scoring_cli_matches_jax(scored, tmp_path):
    """The two-stage scoring CLI on 2 gloo ranks (the split's 3 test images
    as shards of 2 and 1, each rank's model scoring its own): every rank
    gets JAX's metrics, as in one process."""
    metrics, work, opts = scored
    args = [CONFIG, str(work), "--device", "cpu", "--batch-size", "2", "--cfg-options", *opts]
    for rank, got in enumerate(run_ranks(twostage_cli_scoring, 2, tmp_path, args, timeout=240)):
        for run, (m, images) in got.items():
            assert images == (2, 1)[rank], (run, rank, images)
            want = {k: v for k, v in metrics[run].items() if not k.endswith(
                ("_eval_time_s", "_images_per_s"))}
            assert set(want) <= set(m), run
            for k in want:
                assert m[k] == pytest.approx(want[k], abs=1e-12), (run, k)


def test_sgdet_through_the_tiny_detector(scored):
    """sgdet: the frozen tiny detector (seeded), the fusion, all pairs of
    its segments; JAX's sgdet key set, every value finite."""
    _, work, opts = scored
    got = test_cli.main([CONFIG, str(work), "--device", "cpu", "--eval", "sgdet",
                         "--batch-size", "2", "--cfg-options", *opts, *DETECTOR])
    gt = SGGroundTruth(labels=np.array([1, 2]), rels=np.array([[0, 1, 1]]),
                       masks=np.ones((2, 4, 4), bool), boxes=np.zeros((2, 4)))
    pred = SGPrediction(labels=np.array([1, 2]), rel_pair_idxes=np.array([[0, 1]]),
                        rel_dists=np.full((1, 57), 1 / 57), masks=np.ones((2, 4, 4), bool))
    keys = set(j_sgg_evaluate([gt], [pred], mode="sgdet", num_predicates=56))
    assert set(got) == keys | {"sgdet_eval_time_s", "sgdet_images_per_s"}
    assert all(np.isfinite(v) for v in got.values())


def test_pq_on_a_two_stage_config_exits(scored):
    _, work, opts = scored
    with pytest.raises(SystemExit, match="PQ for the two-stage path"):
        test_cli.main([CONFIG, str(work), "--device", "cpu", "--eval", "PQ", "--cfg-options",
                       *opts])


@pytest.mark.parametrize("cli, config", [("test", "panoptic_fpn_r50_sgcls_psg.py"),
                                         ("train", "panoptic_fpn_r50_sgcls_psg.py"),
                                         ("train", "panoptic_fpn_r50_sgdet_psg.py")])
def test_motifs_outside_predcls_on_gt_boxes_raises(tmp_path, monkeypatch, cli, config):
    """The MOTIFS sgcls and sgdet heads embed ``det_dists``, which GT-box
    batches lack (JAX's CLIs fail there too): scoring sgcls and training
    raise, naming them."""
    monkeypatch.setenv("PAIRNET_LOADER_WORKERS", "0")
    path = os.path.join(REPO, "configs", "motifs", config)
    argv = (["--eval", "sgcls", "--batch-size", "2"] if cli == "test"
            else ["--work-dir", str(tmp_path / "work"), "--max-steps", "1"])
    with pytest.raises(ValueError, match="det_dists"):
        (test_cli if cli == "test" else train_cli).main(
            [path, "--device", "cpu", *argv, "--cfg-options", *tiny_options()])


def test_train_cli_trains_and_resumes(tmp_path, monkeypatch):
    """2 steps of the tiny MOTIFS (the split's 5 train images make 2 batches
    of 2: epoch 1), then ``--resume --max-steps 4`` continues at epoch 1;
    the losses are finite and a head parameter moved."""
    monkeypatch.setenv("PAIRNET_LOADER_WORKERS", "0")
    opts = tiny_options()
    work = tmp_path / "work"
    first = train_cli.main([CONFIG, "--device", "cpu", "--work-dir", str(work), "--max-steps",
                            "2", "--cfg-options", *opts])
    assert first["start_epoch"] == 0 and first["steps_per_epoch"] == 2
    assert set(first["last"]) == {"loss_refine_obj", "loss_rel", "loss_total", "grad_norm"}
    assert all(np.isfinite(v) for v in first["last"].values())
    again = train_cli.main([CONFIG, "--device", "cpu", "--work-dir", str(work), "--max-steps",
                            "4", "--resume", "--cfg-options", *opts])
    assert again["start_epoch"] == 1 and again["checkpoints"][-1].endswith("epoch_2.pt")
    sd1 = torch.load(work / "ckpts" / "epoch_1.pt", weights_only=False)["state"]["model"]
    sd2 = torch.load(work / "ckpts" / "epoch_2.pt", weights_only=False)["state"]["model"]
    key = "relation_head.rel_compress.weight"
    assert not torch.equal(sd1[key], sd2[key])
    for k in sd1:  # the BatchNorm statistics never move
        if "running_" in k:
            assert torch.equal(sd1[k], sd2[k]), k
