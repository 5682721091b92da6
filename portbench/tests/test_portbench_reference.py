"""The plain reference against the port at tiny widths on the CPU, in
float32: the serving forward and post-processing, and the train step."""

import json
import time

import pytest
import torch

from portbench import sut
from portbench.families import pairnet as family
from portbench.reference import init, pairnet, post
from portbench.registry import Bench
from portbench.run import run_cell
from portbench.tests.tiny import BACKBONES, TINY_HEAD

KEYS = ("cls", "mask", "rel", "importance", "sub", "obj", "sub_seg", "obj_seg")


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_forward_and_postprocess_match_the_port(backbone):
    cfg = {"backbone": BACKBONES[backbone], "head": TINY_HEAD}
    weights = init.make_weights(pairnet.param_specs(cfg), 3, "cpu")
    model = family.build(cfg, weights, "cpu", torch.float32, "plain")
    images = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, preds = sut.serve(model, images, 4)
        ref = pairnet.forward(weights, images, cfg)
    assert torch.equal(ref["sub_pos"], out["sub_pos"])
    assert torch.equal(ref["obj_pos"], out["obj_pos"])
    for k in KEYS:
        torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=1e-4)
    for b in range(2):
        want = post.triplets({k: out[k][b] for k in KEYS}, 4)
        for field, have, w in zip(post.FIELDS, preds[b], want):
            assert torch.equal(have, w), field


def test_train_step_matches_the_port_in_float32(tiny_root, tmp_path):
    """The train cell at float32 compute: the reference, replaying the
    port's decisions, follows its three steps to rounding."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    root = tmp_path / "root"
    import shutil

    shutil.copytree(tiny_root, root)
    path = root / "portbench" / "configs" / "tiny_r50.json"
    cfg = json.loads(path.read_text())
    cfg["train"]["compute_dtype"] = "float32"
    path.write_text(json.dumps(cfg))
    assert any(w["name"] == "tiny_r50.train_b4" for w in spec["workloads"])
    result, _ = run_cell(Bench(root), "tiny_r50.train_b4", 11, 0.2, False, "cpu",
                         t0=time.perf_counter())
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-3
    assert checks["update_gap_median"] < 1e-3
    assert checks["assign_gap"] < 1e-6 and checks["targets_mismatch"] == 0
