"""The check fails a broken system: the rest of a run is driven on the
CPU at tiny sizes (past the look for a card) with the timed path broken
underneath, and ``correct`` comes out false; the controls fail it too."""

import time

import pytest
import torch

from portbench import control
from portbench.registry import Bench
from portbench.run import run_cell


def run(root, cell):
    result, _ = run_cell(Bench(root), cell, 21, 0.3, False, "cpu", t0=time.perf_counter())
    return result


def test_sound_runs_are_correct(tiny_root):
    for cell in ("tiny_r50.serve_b8", "tiny_r50.train_b4"):
        assert run(tiny_root, cell)["correct"] is True, cell


def test_serving_answer_altered(tiny_root, monkeypatch):
    import pairnet_torch.bench as bench

    post = bench.pairnet_postprocess

    def altered(outputs, b, num_things):
        pred = post(outputs, b, num_things)
        labels = pred.labels.clone()
        labels[0] = labels[0] % 7 + 1
        return pred._replace(labels=labels)

    monkeypatch.setattr(bench, "pairnet_postprocess", altered)
    result = run(tiny_root, "tiny_r50.serve_b8")
    assert result["correct"] is False and result["checks"]["post_mismatch"]["value"] >= 1


def test_serving_half_batch_left_out(tiny_root, monkeypatch):
    import pairnet_torch.bench as bench

    serve = bench.serve

    def half(model, images, num_things=80):
        B = images.shape[0]
        return serve(model, torch.cat([images[: B // 2]] * 2), num_things)

    monkeypatch.setattr(bench, "serve", half)
    result = run(tiny_root, "tiny_r50.serve_b8")
    assert result["correct"] is False and result["checks"]["cls_err"]["value"] > 0.04


def test_training_state_unchanged(tiny_root, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result = run(tiny_root, "tiny_r50.train_b4")
    assert result["correct"] is False
    assert result["checks"]["update_gap_median"]["value"] == pytest.approx(1.0)


def test_training_half_batch_in_the_loss(tiny_root, monkeypatch):
    import pairnet_torch.train.trainer as trainer

    get = trainer.get_loss_fn

    def halved(head_type, cfg, reduce=None):
        loss = get(head_type, cfg, reduce)

        def fn(outputs, batch, points, cum, targets=None):
            n = points.shape[0] // 2
            cut = {k: v[:n] for k, v in outputs.items()}
            kept = {k: v[:n] for k, v in batch.items()}
            return loss(cut, kept, points[:n], cum, targets=type(targets)(*(t[:n] for t in targets)))

        fn.num_points = loss.num_points
        return fn

    monkeypatch.setattr(trainer, "get_loss_fn", halved)
    result = run(tiny_root, "tiny_r50.train_b4")
    assert result["correct"] is False and result["checks"]["loss_gap"]["value"] > 1e-4


def test_training_target_altered(tiny_root, monkeypatch):
    import pairnet_torch.train.trainer as trainer

    targets = trainer.pairnet_targets

    def altered(outputs, batch, points):
        t = targets(outputs, batch, points)
        r = t.r_labels.clone()
        k = int(torch.nonzero(r[0] >= 0)[0, 0])
        r[0, k] = (r[0, k] + 1) % 5
        return t._replace(r_labels=r)

    monkeypatch.setattr(trainer, "pairnet_targets", altered)
    result = run(tiny_root, "tiny_r50.train_b4")
    assert result["correct"] is False and result["checks"]["targets_mismatch"]["value"] >= 1


@pytest.mark.parametrize("cell,fault", (("tiny_r50.serve_b1", "fp8"),
                                        ("tiny_r50.train_b4", "fp8"),
                                        ("tiny_r50.train_b4", "swap")))
def test_control_fails(tiny_root, cell, fault):
    """The reference in the system's place, its products' operands rounded
    to fp8 (or, in training, its assignment not the least), comes out not
    correct by the cell's own check."""
    c = Bench(tiny_root).cell(cell)
    if c.mix["kind"] == "train":
        rec = control.train_record(c, 21, "cpu", fault)
    else:
        rec = control.serve_record(c, 21, "cpu")
    assert set(rec.checks) == set(c.config["limits"][c.mix["kind"]])
    assert rec.correct is False, rec.checks
