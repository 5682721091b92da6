"""The port's process-group helpers (``pairnet_torch/parallel/mesh.py``)
against the JAX package's ``parallel/mesh.py``: the per-host dataset shard
bit for bit, the mesh's rank layout, a rank's rows of a global batch, the
collectives over gloo ranks, and the launcher handling."""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from pairnet_tpu.parallel import mesh as j_mesh
from test_torch_dist import Ranks, collectives, fail_or_hang, mesh_layouts, run_ranks
from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from pairnet_torch.config import load_config  # noqa: E402
from pairnet_torch.data.pipeline import Loader  # noqa: E402
from pairnet_torch.parallel import mesh  # noqa: E402
from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "pairnet" / "tiny_synthetic.py")


@pytest.mark.parametrize("n_items,world,seed,epoch", [(103, 4, 7, 3), (64, 8, 7, 3),
                                                      (5, 2, 10086, 0), (50, 3, 0, 1)])
def test_shard_dataset_indices_is_jaxs(monkeypatch, n_items, world, seed, epoch):
    """Every rank's shard equals JAX's on the process of that index."""
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        want = j_mesh.shard_dataset_indices(n_items, seed, epoch)
        got = mesh.shard_dataset_indices(n_items, seed, epoch, rank, world)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_rank_rows():
    batch = {"x": np.arange(24).reshape(6, 4), "y": torch.arange(6)}
    rows = [mesh.rank_rows(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([r["x"] for r in rows]), batch["x"])
    assert torch.equal(rows[1]["y"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rank_rows(batch, 0, 4)


def test_make_mesh_layout_is_jaxs(tmp_path):
    """(2, 2) and (4, 1) meshes of 4 gloo ranks: the rank grid is JAX's
    ``devs.reshape(n_data, n_model)``, and each rank's data and model groups
    are its column and row."""
    shapes = [(2, 2), (4, 1)]
    per_rank = run_ranks(mesh_layouts, 4, tmp_path, shapes)
    for i, (n_data, n_model) in enumerate(shapes):
        jm = j_mesh.make_mesh(n_data=n_data, n_model=n_model)
        want = np.vectorize(lambda d: d.id)(jm.devices).tolist()
        assert jm.shape == {"data": n_data, "model": n_model}
        for rank, got in enumerate(r[i] for r in per_rank):
            assert got["grid"] == want
            d, m = divmod(rank, n_model)
            assert list(got["coord"]) == [d, m]
            assert got["data_group"] == [want[i][m] for i in range(n_data)]
            assert got["model_group"] == want[d]


@pytest.mark.parametrize("balanced", [False, True], ids=["split", "balanced sampler"])
def test_loader_rank_rows_are_the_world1_batches(balanced):
    """At train time (shuffle, crop, multi-scale, flip; the balanced
    sampler's repeats) the ranks' rows of each global batch, stacked, are
    the world-1 loader's batch bit for bit."""
    cfg = load_config(TINY)
    if balanced:
        cfg.set_path("data.dataset.balanced", {"oversample_thr": 0.3})
    dataset = build_dataset(cfg, "train")
    pipe = dataclasses.replace(build_pipeline_cfg(cfg, train=True), flip_prob=0.5,
                               train_scales=(64, 80, 96), crop_prob=0.5, crop_scales=(64, 80),
                               crop_size_range=(48, 80))
    whole = list(Loader(dataset, pipe, 4, train=True, seed=7))
    ranks = [list(Loader(dataset, pipe, 4, train=True, seed=7, rank=r, world=2))
             for r in range(2)]
    assert len(whole) == len(ranks[0]) == len(ranks[1]) == len(dataset) // 4 > 0
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            np.testing.assert_array_equal(np.concatenate([r[i][k] for r in ranks]), v,
                                          err_msg=f"batch {i} {k}")


def test_loader_rank_rows_of_a_padded_batch():
    """Without drop_last the trailing global batch is padded: 5 images at
    a global batch of 4 over 2 ranks; rank 1's rows of the last batch are
    all padding, marked invalid. A global batch that does not divide by the
    world, and the sequential stream at world 2, raise."""
    cfg = load_config(TINY)
    dataset = build_dataset(cfg, "train")
    pipe = build_pipeline_cfg(cfg, train=False)
    whole = list(Loader(dataset, pipe, 4))
    ranks = [list(Loader(dataset, pipe, 4, rank=r, world=2)) for r in range(2)]
    assert [b["batch_valid"].tolist() for b in whole] == [[True] * 4,
                                                         [True, False, False, False]]
    assert [[b["batch_valid"].tolist() for b in r] for r in ranks] == [
        [[True, True], [True, False]], [[True, True], [False, False]]]
    for i, batch in enumerate(whole):
        valid = batch["batch_valid"]
        got = np.concatenate([r[i]["image"] for r in ranks])
        np.testing.assert_array_equal(got[valid], batch["image"][valid])
    with pytest.raises(ValueError, match="does not divide"):
        Loader(dataset, pipe, 3, rank=0, world=2)
    with pytest.raises(ValueError, match="sequential"):
        Loader(dataset, pipe, 4, rank=0, world=2, num_workers=0)


def test_collectives_sum_over_ranks_in_one_call_per_dtype(tmp_path):
    """``all_reduce_coalesced`` sums in place with one all_reduce per dtype
    (f32, f64, bf16: three), whatever the number of tensors; the other
    helpers sum too; every rank ends with the same values."""
    per_rank = run_ranks(collectives, 2, tmp_path)
    for got in per_rank:
        np.testing.assert_array_equal(got["coalesced"][0], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(got["coalesced"][1], np.arange(4.0))
        np.testing.assert_array_equal(got["coalesced"][2], np.full((5,), 2.0))
        np.testing.assert_array_equal(got["coalesced"][3], [3.0])
        assert float(got["coalesced"][4]) == 3.0
        assert sorted(got["coalesced_calls"]) == ["torch.bfloat16", "torch.float32",
                                                  "torch.float64"]
        np.testing.assert_array_equal(got["sum"], [1.0, 10.0])
        np.testing.assert_array_equal(got["arrays"]["a"], np.full((2, 2), 3.0))
        np.testing.assert_array_equal(got["arrays"]["b"], [1.0, 2.0])
        assert got["calls"] == 5  # 3 coalesced + all_reduce_sum + all_reduce_arrays


def test_no_group_is_world_one():
    """Without a process group every collective is the identity and issues
    no call."""
    assert not dist.is_initialized()
    assert mesh.world_info() == (0, 1)
    t = torch.arange(3.0)
    assert mesh.all_reduce_sum(t) is t and t.tolist() == [0.0, 1.0, 2.0]
    grads = [torch.ones(2), torch.ones(3, dtype=torch.bfloat16)]
    mesh.all_reduce_coalesced(grads)
    assert [g.tolist() for g in grads] == [[1.0, 1.0], [1.0, 1.0, 1.0]]
    out = mesh.all_reduce_arrays({"a": [1, 2]})
    assert out["a"].dtype == np.float64 and out["a"].tolist() == [1.0, 2.0]


def test_init_distributed(monkeypatch):
    """No launcher: world 1, no group. Under a launcher's environment (world
    1, port 0) a gloo group for the CPU, torn down by ``distributed``. The
    device defaults to ``cuda:LOCAL_RANK`` (raises without a GPU); a failed
    init raises."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "0")
    try:
        with mesh.distributed("cpu") as (rank, world, device):
            assert (rank, world, device.type) == (0, 1, "cpu")
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            # a group that exists is used as it is, and outlives an inner context
            with mesh.distributed("cpu") as inner:
                assert inner == (0, 1, torch.device("cpu"))
            assert dist.is_initialized()
            t = torch.ones(2)
            mesh.all_reduce_coalesced([t])
            assert t.tolist() == [1.0, 1.0]
        assert not dist.is_initialized()
        monkeypatch.delenv("MASTER_ADDR")  # the rendezvous has no address
        with pytest.raises((RuntimeError, ValueError), match="MASTER_ADDR"):
            mesh.init_distributed("cpu")
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("hang", [False, True], ids=["a rank fails", "every rank hangs"])
def test_spawned_ranks_fail_fast_and_never_outlive_the_deadline(tmp_path, hang):
    """The test harness: a rank's failure raises at once and kills the rank
    waiting on it; ranks that hang fail the test at the deadline. No child
    is left alive either way."""
    deadline = 12 if hang else 90
    t0 = time.monotonic()
    ranks = Ranks(fail_or_hang, 2, tmp_path, hang, timeout=deadline)
    with pytest.raises(AssertionError, match="did not finish" if hang else "fails on purpose"):
        ranks.join()
    assert not any(p.is_alive() for p in ranks.procs)
    # the failure does not wait for the gloo timeout (60 s) of the rank left behind
    assert time.monotonic() - t0 < (deadline + 10 if hang else 55)


def test_parallel_imports_no_jax():
    code = ("import sys, pairnet_torch.parallel.mesh, pairnet_torch.parallel.spatial; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pairnet_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
