"""The port's training entry point: ``python -m pairnet_torch.tools.train``
on the tiny synthetic config on the CPU (train, resume, then the scoring
CLI on the checkpoint the Trainer wrote), the profiler knob, the loss
dispatch, and the ``--load-from`` overlay against the JAX package's
variables."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.tools import test as test_cli  # noqa: E402
from pairnet_torch.tools import train as train_cli  # noqa: E402
from pairnet_torch.train import trainer as trainer_mod  # noqa: E402
from pairnet_torch.train.dispatch import get_loss_fn  # noqa: E402
from pairnet_torch.utils.from_jax import (  # noqa: E402
    _leaves,
    load_jax_variables,
    load_pretrained,
    merge_pretrained,
    unflatten,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pairnet", "tiny_synthetic.py")
SGDET_KEYS = {"sgdet_recall_R@20", "sgdet_mean_recall_mR@100", "sgdet_group_tt_R@50",
              "phrdet_recall_R@100", "sgdet_eval_time_s", "sgdet_images_per_s"}


def _train(work, *extra):
    return train_cli.main([TINY, "--device", "cpu", "--work-dir", str(work), *extra])


def _ckpt(work, epoch):
    return torch.load(work / "ckpts" / f"epoch_{epoch}.pt", map_location="cpu",
                      weights_only=False)


def test_train_cli_trains_resumes_and_is_scored(tmp_path):
    """``--max-steps 2`` trains epoch 1 (the split's 5 train images make 2
    batches of 2) and writes ``config.json`` and ``ckpts/epoch_1.pt``;
    ``--resume --max-steps 4`` continues at epoch 1 from it; the scoring
    CLI scores the ``epoch_2.pt`` the Trainer wrote; a run without
    ``--resume`` starts again at epoch 0."""
    work = tmp_path / "work"
    first = _train(work, "--max-steps", "2")
    assert (first["start_epoch"], first["max_epochs"], first["steps"]) == (0, 1, 2)
    assert first["steps_per_epoch"] == 2
    assert np.isfinite(first["last"]["loss_total"])
    assert json.loads((work / "config.json").read_text())["optimizer"]["lr"] == 1e-3
    ck1 = _ckpt(work, 1)
    assert ck1["epoch"] == 1 and ck1["state"]["step"] == 2
    # lr 1e-3 scaled by batch 2 / auto_scale_lr_base_batch 8, times each multiplier
    groups = ck1["state"]["optimizer"]["param_groups"]
    assert {g["lr_mult"] for g in groups} == {0.0, 0.1, 1.0}
    for g in groups:
        assert g["lr"] == pytest.approx(2.5e-4 * g["lr_mult"])

    second = _train(work, "--resume", "--max-steps", "4")
    assert (second["start_epoch"], second["max_epochs"], second["steps"]) == (1, 2, 2)
    ck2 = _ckpt(work, 2)
    assert ck2["state"]["step"] == 4
    assert not torch.equal(ck2["state"]["model"]["bbox_head.rel_cls_embed.weight"],
                           ck1["state"]["model"]["bbox_head.rel_cls_embed.weight"])
    assert [os.path.basename(p) for p in second["checkpoints"]] == ["epoch_1.pt", "epoch_2.pt"]

    metrics = test_cli.main([TINY, str(work), "--device", "cpu", "--dtype", "f32",
                             "--eval", "sgdet"])
    assert SGDET_KEYS <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())

    fresh = _train(work, "--max-steps", "2")
    assert fresh["start_epoch"] == 0 and _ckpt(work, 1)["state"]["step"] == 2


def test_train_cli_load_from(tmp_path, caplog):
    """``--load-from`` a port checkpoint starts from its weights; a path that
    does not exist logs a warning and trains from scratch."""
    src = tmp_path / "src"
    _train(src, "--max-steps", "2")
    ck = _ckpt(src, 1)["state"]["model"]
    seen = {}

    class Observe(trainer_mod.Trainer):
        """Records the weights the run starts from."""

        def fit(self, *args, **kwargs):
            seen["weights"] = {k: v.clone() for k, v in self.state.model.state_dict().items()}
            return super().fit(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "Trainer", Observe)
        _train(tmp_path / "warm", "--max-steps", "2", "--load-from",
               str(src / "ckpts" / "epoch_1.pt"))
        for name, val in ck.items():
            assert torch.equal(seen["weights"][name], val), name
        with caplog.at_level("WARNING"):
            _train(tmp_path / "cold", "--max-steps", "2", "--load-from",
                   str(tmp_path / "missing.npz"))
    assert "not found; training from scratch" in caplog.text
    assert not torch.equal(seen["weights"]["bbox_head.rel_cls_embed.weight"],
                           ck["bbox_head.rel_cls_embed.weight"])


def test_profiler_knob_writes_a_trace(tmp_path, monkeypatch):
    """``PAIRNET_PROFILE_DIR`` on a split of 5 steps per epoch: iterations
    2-4 of epoch 0 are traced into that directory."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PAIRNET_PROFILE_DIR", str(trace_dir))
    out = _train(tmp_path / "work", "--max-steps", "5", "--cfg-options",
                 "data.dataset.synthetic={'num_images':14,'num_test':3,'seed':1}")
    assert out["steps_per_epoch"] == 5
    trace = trace_dir / "trace_epoch0_iter2-4.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 0


def test_loss_dispatch():
    """PairNetHead's loss takes the config's loss options (``num_points``
    is the sampling's); the one-stage zoo, the box head and the two-stage
    heads dispatch too (VCTree adds its tree loss); an unknown head raises."""
    cfg = load_config(TINY)
    fn = get_loss_fn("PairNetHead", cfg)
    assert fn.num_points == 256 and fn.keywords == {"with_seg_losses": True}
    assert get_loss_fn("PairNetHead", {}).num_points == 12544
    assert get_loss_fn("PSGTrHead", {}).num_points == 0
    assert get_loss_fn("BaselineHead", {"loss": {"use_seesaw": True}}).cum_size(56) == 57
    assert get_loss_fn("CrossHeadBBox", {}).num_points == 0
    assert get_loss_fn("CrossHeadBBox", {"loss": {"detection_only": True}}).cum_size(50) == 50
    for head in ("IMPHead", "MotifHead", "GPSHead", "VCTreeHead"):
        fn = get_loss_fn(head, cfg)
        assert fn.num_points == 0 and fn.cum_size(56) == 56
    with pytest.raises(NotImplementedError, match="head type 'NoSuchHead'"):
        get_loss_fn("NoSuchHead", cfg)


@pytest.fixture(scope="module")
def jax_variables():
    """Seeded numpy variables of the tiny flagship's flax tree (params and
    constants), shaped by ``jax.eval_shape`` of its init."""
    jm = _flagship(tiny=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) if s.shape else
        np.float32(rng.normal()), {c: dict(shapes[c]) for c in ("params", "constants")})


def _npz(path, variables, drop=(), edit=None):
    """``variables`` flattened with "/" into ``path`` (the ``.npz`` the JAX
    CLI's ``--load-from`` reads), leaving out the keys starting with one of
    ``drop`` and applying ``edit`` to the flat dict."""
    flat = {"/".join((col,) + p): np.asarray(v) for col, tree in variables.items()
            for p, v in _leaves(tree)}
    flat = {k: v for k, v in flat.items() if not k.startswith(drop)}
    if edit:
        edit(flat)
    np.savez(path, **flat)
    return str(path)


def test_load_from_npz_equals_load_jax_variables(jax_variables, tmp_path):
    model = load_pretrained(flagship(tiny=True, device="cpu"),
                            _npz(tmp_path / "w.npz", jax_variables))
    want = load_jax_variables(flagship(tiny=True, device="cpu"), jax_variables)
    sd, wsd = model.state_dict(), want.state_dict()
    assert set(sd) == set(wsd)
    for k in wsd:
        assert torch.equal(sd[k], wsd[k]), k
    flat = np.load(tmp_path / "w.npz")
    assert unflatten(dict(flat)).keys() == {"params", "constants"}


def test_load_from_overlay_rules(jax_variables, tmp_path):
    """An unknown key raises, a shape mismatch raises, a missing key keeps
    its init; a port checkpoint follows the same rules."""
    def unknown(flat):
        flat["params/bbox_head/no_such_module/kernel"] = np.zeros((2, 2), np.float32)

    def reshaped(flat):
        key = "params/bbox_head/rel_cls_embed/kernel"
        flat[key] = flat[key][:, :-1]

    with pytest.raises(KeyError, match="no_such_module"):
        load_pretrained(flagship(tiny=True, device="cpu"),
                        _npz(tmp_path / "u.npz", jax_variables, edit=unknown))
    with pytest.raises(ValueError, match="shape mismatch at bbox_head.rel_cls_embed.weight"):
        load_pretrained(flagship(tiny=True, device="cpu"),
                        _npz(tmp_path / "s.npz", jax_variables, edit=reshaped))
    init = flagship(tiny=True, device="cpu").state_dict()
    model = load_pretrained(flagship(tiny=True, device="cpu"),
                            _npz(tmp_path / "m.npz", jax_variables, drop=("params/backbone/",
                                                                          "constants/")))
    full = load_jax_variables(flagship(tiny=True, device="cpu"), jax_variables).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k] if k.startswith("backbone.") else full[k]), k
    # the same overlay from the tree itself
    merged = merge_pretrained(flagship(tiny=True, device="cpu"),
                              {"params": {"bbox_head": jax_variables["params"]["bbox_head"]}})
    assert torch.equal(merged.state_dict()["bbox_head.rel_cls_embed.weight"],
                       full["bbox_head.rel_cls_embed.weight"])

    sd = dict(full)
    sd.pop("bbox_head.rel_cls_embed.weight")
    torch.save({"epoch": 1, "state": {"model": sd}}, tmp_path / "epoch_1.pt")
    model = load_pretrained(flagship(tiny=True, device="cpu"), str(tmp_path / "epoch_1.pt"))
    assert torch.equal(model.state_dict()["bbox_head.rel_cls_embed.weight"],
                       init["bbox_head.rel_cls_embed.weight"])
    assert torch.equal(model.state_dict()["bbox_head.rel_cls_embed.bias"],
                       full["bbox_head.rel_cls_embed.bias"])
    for bad, err in ((dict(sd, extra=torch.zeros(1)), KeyError),
                     (dict(sd, **{"bbox_head.rel_cls_embed.bias": torch.zeros(3)}), ValueError)):
        torch.save({"epoch": 1, "state": {"model": bad}}, tmp_path / "bad.pt")
        with pytest.raises(err):
            load_pretrained(flagship(tiny=True, device="cpu"), str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="expected an .npz"):
        load_pretrained(flagship(tiny=True, device="cpu"), str(tmp_path / "weights.bin"))


def test_train_cli_val_workflow_and_bf16(tmp_path, monkeypatch):
    """``workflow=['train', 'val']`` ends the epoch with a validation-loss
    pass on the test split, and ``compute_dtype='bfloat16'`` runs the
    forward in bf16 over the f32 masters."""
    seen = []
    forward = trainer_mod.forward

    def observed(model, image, compute_dtype=None):
        seen.append(compute_dtype)
        return forward(model, image, compute_dtype)

    monkeypatch.setattr(trainer_mod, "forward", observed)
    out = _train(tmp_path / "work", "--max-steps", "2", "--cfg-options",
                 "workflow=['train','val']", "compute_dtype=bfloat16")
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert np.isfinite(out["last"]["val_loss_total"]) and np.isfinite(out["last"]["loss_total"])
