"""A JAX training run carried into the port: the JAX ``Trainer``'s orbax
checkpoint, ``tools/export_orbax.py``, ``pairnet_torch.tools.import_jax``,
and then the port's CLIs on the imported work dir (f32, CPU).

The tiny flagship (``configs/pairnet/tiny_synthetic.py`` on the port's
8-image synthetic split, ``relation_ffn_drop`` 0 so that no dropout
stream has to match) trains one epoch (2 steps of batch 2) with JAX's
``Trainer`` as ``tools/train.py`` builds it, on one device. Then:

* the export holds the whole ``TrainState`` under "/"-joined paths;
* the imported checkpoint holds JAX's variables, Adam moments, step and
  Seesaw counts (the tensors of ``load_jax_train_state``);
* JAX's ``tools/test.py`` on the orbax dir and the port's test CLI on the
  imported dir give the same sgdet and PQ metrics, value for value (as
  ``tests/test_torch_eval_cli.py`` holds them);
* one step from the imported state and JAX's next step, on a batch given
  to both, agree within ``tests/test_torch_train.py``'s limits (losses
  within 1e-4, the parameters within the Adam-step limit);
* the port's ``--resume`` continues the imported run at its epoch.

The two-stage MOTIFS predcls config (tiny), whose variables hold
``batch_stats``, goes through a bare ``{"params": variables}`` checkpoint:
exported, imported as weights only, scored to JAX's predcls metrics, and
refused by ``--resume``. A directory given to ``--load-from`` raises,
naming the exporter; the exporter imports neither the JAX package nor
torch.
"""

import json
import os
import pickle
import runpy
import subprocess
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
from pairnet_tpu.parallel.mesh import make_mesh, shard_batch
from pairnet_tpu.train import builder as j_builder
from pairnet_tpu.train.dispatch import get_loss_fn as j_get_loss_fn
from pairnet_tpu.train.optim import build_optimizer as j_build_optimizer
from pairnet_tpu.train.optim import step_lr_schedule as j_step_lr_schedule
from pairnet_tpu.train.trainer import TrainState as JTrainState
from pairnet_tpu.train.trainer import Trainer as JTrainer
from test_torch_helpers import TINY_SPLIT, jax_dataset, perturb
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import apply_overrides, load_config  # noqa: E402
from pairnet_torch.tools import import_jax  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train import trainer as trainer_mod  # noqa: E402
from pairnet_torch.train.builder import build_model, synthetic_root  # noqa: E402
from pairnet_torch.train.optim import lr_mult_tree, step_lr_schedule  # noqa: E402
from pairnet_torch.train.trainer import make_train_step  # noqa: E402
from pairnet_torch.utils.from_jax import (  # noqa: E402
    load_jax_train_state,
    load_jax_variables,
    load_pretrained,
    port_arrays,
    read_jax_export,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
MOTIFS = os.path.join(REPO, "configs", "motifs", "panoptic_fpn_r50_predcls_psg.py")
EXPORTER = os.path.join(REPO, "tools", "export_orbax.py")
MOTIFS_TINY = ["data.pipeline.target_size=(96,128)", "data.pipeline.max_inst=8",
               "model.backbone.depth=26", "model.backbone.base_width=8",
               "model.relation_head.hidden_dim=32", "model.relation_head.roi_dim=64",
               "model.relation_head.context_pooling_dim=96", "model.relation_head.embed_dim=16",
               "model.relation_head.num_classes=8", "model.relation_head.num_predicates=6",
               "num_object_classes=7", "num_relation_classes=5", "evaluation.num_things=4",
               "data.samples_per_device=2"]
G, R = 8, 10  # the tiny pipeline's max_inst and max_rels
B = 2


def options():
    """The tiny flagship on the port's synthetic split (the same files for
    both packages), without relation dropout."""
    return [f"data.dataset.data_root={synthetic_root(TINY_SPLIT)}", "data.dataset.synthetic=False",
            "model.bbox_head.relation_ffn_drop=0.0"]


def export(work, out):
    """``tools/export_orbax.py`` in this process."""
    argv = sys.argv
    sys.argv = [EXPORTER, str(work), "--out", str(out)]
    try:
        runpy.run_path(EXPORTER, run_name="__main__")
    finally:
        sys.argv = argv
    return out


def jax_cli(config, work, out, *args):
    """JAX's ``tools/test.py`` on an orbax work dir; its metrics."""
    argv = sys.argv
    sys.argv = ["tools/test.py", config, str(work), "--out", str(out), *args]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "test.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return json.loads(out.read_text())


def base_lr(cfg, batch):
    lr = cfg.optimizer.lr
    if cfg.optimizer.get("auto_scale_lr_base_batch"):
        lr = lr * batch / cfg.optimizer.auto_scale_lr_base_batch
    return lr


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-epoch run (its trainer and state), the export, the port
    work dir it was imported into, and JAX's CLI metrics on the orbax dir."""
    root = tmp_path_factory.mktemp("bridge")
    opts = options()
    jcfg = j_apply_overrides(j_load_config(TINY), opts)
    dataset = jax_dataset(synthetic_root(TINY_SPLIT), "train")
    pipe_cfg = j_builder.build_pipeline_cfg(jcfg, train=True)
    jm = j_builder.build_detector(jcfg)
    variables = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                        seed=2, std=0.05)
    # sharper class predictions, so that the next step's assignments are decided
    variables["params"]["bbox_head"]["transformer_decoder"]["cls_embed"]["kernel"] *= 4
    seed = jcfg.seed

    def loader_fn(epoch):
        return JLoader(dataset, pipe_cfg, B, train=True, seed=seed + epoch)

    steps_per_epoch = len(loader_fn(0))
    lr = base_lr(jcfg, B)
    tx = j_build_optimizer(variables["params"], weight_decay=jcfg.optimizer.weight_decay,
                           grad_clip=jcfg.optimizer.grad_clip,
                           custom_lr_keys=dict(jcfg.optimizer.custom_lr_keys),
                           schedule=j_step_lr_schedule(lr, steps_per_epoch,
                                                       jcfg.schedule.decay_epochs,
                                                       jcfg.schedule.gamma))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx,
                               jcfg.num_relation_classes, seed=seed)
    jwork = root / "jax"
    trainer = JTrainer(jm, tx, state, str(jwork), mesh=make_mesh(n_data=1),
                       loss_fn=j_get_loss_fn("PairNetHead", jcfg), log_interval=1)
    trainer.fit(loader_fn, max_epochs=1)

    npz = export(jwork, root / "run.npz")
    pwork = root / "port"
    imported = import_jax.main([TINY, str(npz), "--work-dir", str(pwork), "--device", "cpu",
                                "--cfg-options", *opts])
    save = {"sgdet": ["--save-results", str(root / "jax_results.pkl")], "PQ": []}
    jax_metrics = {what: jax_cli(TINY, jwork, root / f"{what}.json", "--eval", what, "--dtype",
                                 "f32", "--batch-size", "3", *save[what], "--cfg-options", *opts)
                   for what in ("sgdet", "PQ")}
    return dict(root=root, opts=opts, jcfg=jcfg, trainer=trainer, jwork=jwork, npz=npz,
                pwork=pwork, imported=imported, jax_metrics=jax_metrics, lr=lr,
                steps_per_epoch=steps_per_epoch,
                state=jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state)))


def _port_ckpt(work, epoch):
    return torch.load(work / "ckpts" / f"epoch_{epoch}.pt", map_location="cpu",
                      weights_only=False)


def test_export_holds_the_train_state(run):
    tree, step = read_jax_export(run["npz"])
    assert step == 1 and run["steps_per_epoch"] == 2
    assert set(tree) == {"params", "opt_state", "step", "cum_samples", "rng"}
    assert set(tree["params"]) == {"params", "constants"}
    adam = tree["opt_state"]["1"]["0"]
    assert set(adam) == {"count", "mu", "nu"} and int(adam["count"]) == 2
    assert int(tree["step"]) == 2
    np.testing.assert_array_equal(tree["cum_samples"], run["state"].cum_samples)
    got = tree["params"]["params"]["bbox_head"]
    np.testing.assert_array_equal(got["rel_cls_embed"]["kernel"],
                                  run["state"].params["params"]["bbox_head"]["rel_cls_embed"]
                                  ["kernel"])


def test_import_carries_the_jax_state(run):
    """The imported checkpoint holds JAX's variables, Adam's moments and
    count, step and Seesaw counts; the generator is the port's own, seeded."""
    assert run["imported"] == {"checkpoint": str(run["pwork"] / "ckpts" / "epoch_1.pt"),
                               "epoch": 1, "step": 2, "resumable": True}
    ckpt = _port_ckpt(run["pwork"], 1)
    assert ckpt["epoch"] == 1
    jstate = run["state"]
    cfg = apply_overrides(load_config(TINY), run["opts"])
    state, _, _ = train_cli.build_train_state(cfg, torch.device("cpu"), 10086, B)
    state.load_state_dict(ckpt["state"])
    want = load_jax_variables(build_model(cfg.model, device="cpu"), jstate.params)
    for k, v in want.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert state.step == 2
    np.testing.assert_array_equal(state.cum_samples.numpy(), jstate.cum_samples)
    adam = jstate.opt_state[1][0]
    mu = port_arrays(want, {"params": adam.mu})
    nu = port_arrays(want, {"params": adam.nu})
    for name, p in state.model.named_parameters():
        m = state.optimizer.state[p]
        assert float(m["step"]) == 2.0, name
        np.testing.assert_array_equal(m["exp_avg"].numpy(), mu[name], err_msg=name)
        np.testing.assert_array_equal(m["exp_avg_sq"].numpy(), nu[name], err_msg=name)
    assert torch.equal(ckpt["state"]["generator"],
                       torch.Generator().manual_seed(10086).get_state())


@pytest.mark.parametrize("what", ["sgdet", "PQ"])
def test_scores_equal_jax_cli(run, what, tmp_path):
    """The port's test CLI on the imported dir gives JAX's ``tools/test.py``
    metrics on the orbax dir, value for value (timing keys aside); sgdet
    scores on the host oracle with each CLI's predictions pickled, and the
    two pickles agree: labels, relation pairs and mask bits equal, boxes
    and relation scores within rounding (random weights score 0, so the
    predictions carry the check)."""
    results = tmp_path / "port_results.pkl"
    save = ["--save-results", str(results)] if what == "sgdet" else []
    got = test_cli.main([TINY, str(run["pwork"]), "--device", "cpu", "--eval", what, "--dtype",
                         "f32", "--batch-size", "3", *save, "--cfg-options", *run["opts"]])
    want = dict(run["jax_metrics"][what])
    timing = {f"{what}_eval_time_s", f"{what}_images_per_s"}
    assert set(got) == set(want)
    for k in timing:
        del got[k], want[k]
    assert got == want
    if not save:
        return
    with open(results, "rb") as f:
        port_rows = pickle.load(f)
    with open(run["root"] / "jax_results.pkl", "rb") as f:
        jax_rows = pickle.load(f)
    assert len(port_rows) == len(jax_rows) == 3
    for t, j in zip(port_rows, jax_rows):
        assert set(t) == set(j)
        assert len(j["labels"]) > 0 and len(j["rel_pair_idxes"]) > 0
        for k in ("labels", "rel_pair_idxes", "mask_shape", "masks_packed"):
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)
        assert (t["boxes"] is None) == (j["boxes"] is None)  # pan_seg scoring: no boxes
        np.testing.assert_allclose(t["rel_dists"].astype(np.float32),
                                   j["rel_dists"].astype(np.float32), atol=1e-3, rtol=0)


def _next_batch(model, loader_batch):
    """The loader's batch with GT that the model's own predictions decide:
    the segments are the predicted masks of the queries that its top
    relation picks use, labelled with their predicted classes, and the
    relations are those picks; so every assignment of the step's targets
    (segments, then triplets) has a clear winner."""
    rng = np.random.default_rng(5)
    images = loader_batch["image"]
    with torch.no_grad():
        out = model.eval()(torch.tensor(images))
    labels = np.zeros((B, G), np.int32)
    masks = np.zeros(loader_batch["gt_masks"].shape, bool)
    rels = np.zeros((B, R, 3), np.int32)
    n_rels = np.zeros(B, int)
    for b in range(B):
        segs = []
        for s_q, o_q in zip(out["sub_pos"][b].tolist(), out["obj_pos"][b].tolist()):
            new = [q for q in dict.fromkeys((s_q, o_q)) if q not in segs]
            if len(segs) + len(new) > G - 1 or n_rels[b] == R - 2:
                break
            segs += new
            rels[b, n_rels[b]] = segs.index(s_q), segs.index(o_q), rng.integers(1, 6)
            n_rels[b] += 1
        labels[b, :len(segs)] = out["cls"][b, segs, :-1].argmax(-1).numpy()
        masks[b, :len(segs)] = out["mask"][b, segs].numpy() > 0
        assert n_rels[b] >= 3, n_rels
    boxes = np.zeros((B, G, 4), np.float32)  # xyxy pixels of the stride-4 masks
    for b, g in np.ndindex(B, G):
        ys, xs = np.nonzero(masks[b, g])
        if len(ys):
            boxes[b, g] = [xs.min() * 4, ys.min() * 4, (xs.max() + 1) * 4, (ys.max() + 1) * 4]
    return dict(loader_batch, gt_labels=labels, gt_masks=masks, gt_boxes=boxes,
                gt_valid=masks.any((2, 3)), gt_rels=rels,
                rel_valid=np.arange(R)[None] < n_rels[:, None])


def test_next_step_from_the_import_matches_jax(run, monkeypatch):
    """One step from the imported checkpoint and JAX's step from its state,
    on the same batch and the JAX step's mask-cost points: the losses within
    1e-4, the parameters within the Adam-step limit of
    ``test_torch_train.py::test_second_step_from_loaded_jax_state`` (here
    Adam's third step)."""
    cfg = apply_overrides(load_config(TINY), run["opts"])
    state, lr, head_type = train_cli.build_train_state(cfg, torch.device("cpu"), cfg.seed, B)
    state.load_state_dict(_port_ckpt(run["pwork"], 1)["state"])
    assert lr == run["lr"] and state.step == 2

    trainer = run["trainer"]
    jstate = trainer.state
    _, points_rng, _ = jax.random.split(jstate.rng, 3)
    points = np.asarray(jax.random.uniform(points_rng, (B, cfg.loss.num_points, 2)))
    loader_batch = next(iter(JLoader(jax_dataset(synthetic_root(TINY_SPLIT), "train"),
                                     j_builder.build_pipeline_cfg(run["jcfg"], train=True), B,
                                     train=True, seed=0)))
    batch = _next_batch(state.model, loader_batch)
    assert {k: (v.shape, v.dtype) for k, v in loader_batch.items()} == {
        k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in batch.items()}
    state.model.train()
    jstate2, jm = trainer._step_fn(jstate, shard_batch(trainer.mesh, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    jstate2 = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate2))

    monkeypatch.setattr(trainer_mod, "sample_points", lambda *a: torch.tensor(points))
    step = make_train_step(state.model, state.optimizer, dict(cfg.loss),
                           schedule=step_lr_schedule(lr, run["steps_per_epoch"],
                                                     cfg.schedule.decay_epochs,
                                                     cfg.schedule.gamma),
                           grad_clip=cfg.optimizer.grad_clip, head_type=head_type)
    got = {k: float(v) for k, v in step(state, {k: torch.tensor(np.asarray(v))
                                                for k, v in batch.items()}).items()}
    assert set(got) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(state.cum_samples.numpy(), jstate2.cum_samples)

    model = state.model
    adam3 = jstate2.opt_state[1][0]
    mu3 = port_arrays(model, {"params": adam3.mu})
    nu3 = port_arrays(model, {"params": adam3.nu})
    after = port_arrays(model, {"params": jstate2.params["params"]})
    mults = lr_mult_tree(model, dict(cfg.optimizer.custom_lr_keys))
    for name, p in model.named_parameters():
        moments = state.optimizer.state[p]
        assert int(moments["step"]) == 3, name
        d = np.abs(moments["exp_avg"].numpy().astype(np.float64) - mu3[name]) / 0.1
        v_hat = np.sqrt(nu3[name].astype(np.float64) / (1 - 0.999 ** 3))
        tol = lr * mults[name] * np.minimum(2.0, 1e-3 + 2 * d / (v_hat + 1e-8)) \
            + 2 * np.spacing(np.abs(after[name]))
        np.testing.assert_array_less(np.abs(p.detach().numpy() - after[name]), tol, err_msg=name)


def test_resume_continues_the_imported_run(run, tmp_path):
    """``tools.train --resume`` starts at the imported epoch and steps on
    from JAX's step count."""
    work = tmp_path / "resumed"
    work.mkdir()
    (work / "ckpts").mkdir()
    (work / "ckpts" / "epoch_1.pt").write_bytes((run["pwork"] / "ckpts" / "epoch_1.pt")
                                                .read_bytes())
    out = train_cli.main([TINY, "--device", "cpu", "--work-dir", str(work), "--resume",
                          "--max-epochs", "2", "--cfg-options", *run["opts"]])
    assert (out["start_epoch"], out["max_epochs"], out["steps"]) == (1, 2, 2)
    assert np.isfinite(out["last"]["loss_total"])
    assert _port_ckpt(work, 2)["state"]["step"] == 4


def test_load_from_reads_the_export_and_refuses_a_directory(run):
    """``--load-from`` of the export takes its variables (JAX's
    ``raw["params"]``); of the orbax directory, it raises naming the
    exporter."""
    cfg = apply_overrides(load_config(TINY), run["opts"])
    model = load_pretrained(build_model(cfg.model, device="cpu", seed=7), str(run["npz"]))
    want = load_jax_variables(build_model(cfg.model, device="cpu"), run["state"].params)
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    for path in (run["jwork"], run["jwork"] / "ckpts"):
        with pytest.raises(ValueError, match="tools/export_orbax.py"):
            train_cli.main([TINY, "--device", "cpu", "--work-dir", str(run["root"] / "w"),
                            "--max-steps", "1", "--load-from", str(path),
                            "--cfg-options", *run["opts"]])


def test_load_jax_train_state_takes_the_restored_tree(run):
    """The raw tree of a target-free orbax restore (lists for tuples, None
    for empty states) carries the same state as the ``TrainState`` object."""
    mgr = ocp.CheckpointManager(str(run["jwork"] / "ckpts"))
    raw = mgr.restore(1, args=ocp.args.StandardRestore())
    assert raw["opt_state"][0] is None and isinstance(raw["opt_state"][1][0], dict)
    cfg = apply_overrides(load_config(TINY), run["opts"])
    states = []
    for src in (raw, run["state"]):
        state, _, _ = train_cli.build_train_state(cfg, torch.device("cpu"), 10086, B)
        load_jax_train_state(state, src)
        states.append(state)
    a, b = (s.state_dict() for s in states)
    assert a["step"] == b["step"] == 2
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, m in a["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(m[key], b["optimizer"]["state"][i][key]), (i, key)


def test_exporter_imports_neither_the_jax_package_nor_torch(run, tmp_path):
    """``tools/export_orbax.py`` in a fresh interpreter: its export equals
    the in-process one and it loaded no ``pairnet_tpu`` and no ``torch``."""
    out = tmp_path / "sub.npz"
    code = ("import runpy, sys\n"
            f"sys.argv = [{EXPORTER!r}, {str(run['jwork'])!r}, '--out', {str(out)!r}]\n"
            f"runpy.run_path({EXPORTER!r}, run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pairnet_tpu', 'pairnet_torch', 'torch'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with np.load(out) as a, np.load(run["npz"]) as b:
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def twostage(tmp_path_factory):
    """A tiny MOTIFS predcls model's seeded variables (with ``batch_stats``)
    in a bare ``{"params": variables}`` orbax checkpoint, JAX's predcls
    metrics on it, its export and the weights-only import."""
    root = tmp_path_factory.mktemp("twostage")
    opts = [f"data.dataset.data_root={synthetic_root(TINY_SPLIT)}",
            "data.dataset.synthetic=False", *MOTIFS_TINY]
    jcfg = j_apply_overrides(j_load_config(MOTIFS), opts)
    dataset = jax_dataset(synthetic_root(TINY_SPLIT), "test")
    jm = j_builder.build_detector(jcfg)
    init_batch = {k: jnp.asarray(v) for k, v in next(iter(JLoader(
        dataset, j_builder.build_pipeline_cfg(jcfg, train=False), 1, train=False, seed=0,
        sample_transform=lambda s, rng: j_to_twostage_batch(s, 56, train=False,
                                                            rng=rng)))).items()}
    variables = jax.tree_util.tree_map(np.asarray, perturb(
        jax.jit(jm.init)(jax.random.PRNGKey(0), init_batch), seed=1, std=0.05))
    assert "batch_stats" in variables
    jwork = root / "jax"
    mgr = ocp.CheckpointManager(str(jwork / "ckpts"))
    mgr.save(3, args=ocp.args.StandardSave({"params": variables}))
    mgr.wait_until_finished()
    want = jax_cli(MOTIFS, jwork, root / "predcls.json", "--eval", "predcls", "--eval-engine",
                   "numpy", "--batch-size", "2", "--cfg-options", *opts)
    npz = export(jwork, root / "motifs.npz")
    pwork = root / "port"
    imported = import_jax.main([MOTIFS, str(npz), "--work-dir", str(pwork), "--device", "cpu",
                                "--cfg-options", *opts])
    return dict(root=root, opts=opts, want=want, npz=npz, pwork=pwork, imported=imported,
                variables=variables)


def test_twostage_params_only_round_trip_scores_as_jax(twostage):
    """The weights-only import (``batch_stats`` included) scores JAX's
    predcls metrics."""
    assert twostage["imported"]["resumable"] is False and twostage["imported"]["epoch"] == 3
    sd = _port_ckpt(twostage["pwork"], 3)["state"]
    assert set(sd) == {"step", "model"}
    stats = [k for k in sd["model"] if k.endswith(("running_mean", "running_var"))
             and k.startswith("relation_head.")]
    assert stats
    got = test_cli.main([MOTIFS, str(twostage["pwork"]), "--device", "cpu", "--eval", "predcls",
                         "--eval-engine", "numpy", "--batch-size", "2",
                         "--cfg-options", *twostage["opts"]])
    want = dict(twostage["want"])
    timing = {"predcls_eval_time_s", "predcls_images_per_s"}
    assert set(got) == set(want)
    assert any(v > 0 for k, v in want.items() if k not in timing)
    for k in set(want) - timing:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_resume_of_a_params_only_import_raises(twostage):
    with pytest.raises(ValueError, match="holds no optimizer, cum_samples, generator"):
        train_cli.main([MOTIFS, "--device", "cpu", "--work-dir", str(twostage["pwork"]),
                        "--resume", "--max-epochs", "4", "--cfg-options", *twostage["opts"]])





