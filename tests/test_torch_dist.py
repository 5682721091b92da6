"""Harness of the port's multi-process tests, and the functions their ranks run.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes
(``torch.multiprocessing``'s spawn context); each sets one thread, joins a
gloo process group through a ``FileStore`` under ``tmp_path`` (no port, so
no race between test workers) with a 60 s timeout, calls ``fn(rank, world,
*args)`` and sends back what it returns. The harness waits at most
``timeout`` seconds in all, kills every child that is still alive and
raises on a rank's failure or on the deadline: a hang fails the test.

Imports torch, numpy and ``pairnet_torch`` only: the ranks import this
module, never JAX. Holds no tests itself.
"""

import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT = 150.0  # s for a whole spawned run: start-up, work and exit


def _entry(fn, rank, world, store_path, results, args, env):
    torch.set_num_threads(1)
    os.environ.update(env)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Spawned ranks running ``fn``; :meth:`join` collects their results
    in rank order. Start them, do other work, then join."""

    def __init__(self, fn, world, tmp_path, *args, timeout=SPAWN_TIMEOUT, env=None):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.deadline = world, time.monotonic() + timeout
        self.results = ctx.Queue()
        store = str(tmp_path / f"store_{fn.__name__}_{time.monotonic_ns()}")
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(fn, r, world, store, self.results, args, env or {}))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self) -> list:
        got = {}
        done = False
        try:
            while len(got) < self.world:
                left = self.deadline - time.monotonic()
                try:
                    rank, ok, out = self.results.get(timeout=max(left, 0.01))
                except queue.Empty:
                    raise AssertionError(f"ranks {sorted(set(range(self.world)) - set(got))} "
                                         "did not finish before the deadline") from None
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            done = True
        finally:
            # after a failure the other ranks may wait in a collective: kill them now
            for p in self.procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 1.0) if done else 0.1)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        assert not any(p.is_alive() for p in self.procs)
        return [got[r] for r in range(self.world)]


def run_ranks(fn, world, tmp_path, *args, timeout=SPAWN_TIMEOUT, env=None) -> list:
    return Ranks(fn, world, tmp_path, *args, timeout=timeout, env=env).join()


def calls(rank, world, named_calls):
    """Several rank functions in one spawn: ``{name: fn(rank, world,
    *args)}`` for each ``(name, fn, args)``, in order."""
    return {name: fn(rank, world, *args) for name, fn, args in named_calls}


# --- rank functions of tests/test_torch_parallel.py ---

def fail_or_hang(rank, world, hang):
    """Rank 1 raises, or (``hang``) every rank sleeps past any deadline."""
    if hang:
        time.sleep(3600)
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # rank 0 waits here for a rank that never comes
    return rank


def mesh_layouts(rank, world, shapes):
    """Per (n_data, n_model): the mesh's rank grid, this rank's coordinate
    and the ranks of its data and model groups."""
    from pairnet_torch.parallel.mesh import make_mesh

    out = []
    for n_data, n_model in shapes:
        mesh = make_mesh(n_data, n_model)
        out.append({"grid": mesh.mesh.tolist(), "coord": mesh.get_coordinate(),
                    "data_group": dist.get_process_group_ranks(mesh["data"].get_group()),
                    "model_group": dist.get_process_group_ranks(mesh["model"].get_group())})
    return out


def collectives(rank, world):
    """The sums of the mesh helpers, and how many all_reduce calls each made."""
    from pairnet_torch.parallel import mesh

    calls = []
    orig = dist.all_reduce

    def counted(t, *a, **k):
        calls.append(t.dtype)
        return orig(t, *a, **k)

    dist.all_reduce = counted
    try:
        tensors = [torch.full((2, 3), rank + 1.0), torch.arange(4.0, dtype=torch.float64) * rank,
                   torch.full((5,), rank + 0.5, dtype=torch.bfloat16),
                   torch.full((1,), 2.0 ** rank), torch.tensor(rank + 1.0)]
        mesh.all_reduce_coalesced(tensors)
        coalesced_calls = list(calls)
        s = mesh.all_reduce_sum(torch.tensor([rank, 10.0 * rank]))
        arrays = mesh.all_reduce_arrays({"a": np.full((2, 2), rank + 1), "b": [rank, 1]})
    finally:
        dist.all_reduce = orig
    return {"coalesced": [t.float().numpy() for t in tensors],
            "coalesced_calls": [str(d) for d in coalesced_calls],
            "sum": s.numpy(), "arrays": arrays, "calls": len(calls)}


# --- rank functions of tests/test_torch_spatial.py ---

def sp_encoder(rank, world, layer_kw, state_dicts, tokens, pos, ref, shapes, meshes):
    """Per (n_data, n_model) mesh of ``meshes``, the sequence-parallel
    encoder on this rank's batch rows: the stack's output (all layers),
    then each parameter's gradient of the global mean of out**2 through the
    first layer alone, summed over the world; and a gather of each rank's
    index, which must come back in rank order."""
    from pairnet_torch.models.necks.pixel_decoder import DeformableEncoderLayer
    from pairnet_torch.parallel.mesh import all_reduce_coalesced, make_mesh
    from pairnet_torch.parallel.spatial import gather_tokens, sequence_parallel_encoder

    results = []
    for n_data, n_model in meshes:
        mesh = make_mesh(n_data, n_model)
        group = mesh["model"].get_group()
        d = mesh.get_coordinate()[0]
        b = tokens.shape[0] // n_data
        rows = slice(d * b, (d + 1) * b)
        tok, po, rf = (torch.tensor(a[rows]) for a in (tokens, pos, ref))
        layers = []
        for sd in state_dicts:
            layer = DeformableEncoderLayer(**layer_kw, seq_group=group)
            layer.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
            layers.append(layer)
        with torch.no_grad():
            out = sequence_parallel_encoder(layers, tok, po, rf, shapes, group)
            plane = gather_tokens(torch.full((1, 3, 1), float(dist.get_rank(group))), group)
        out1 = sequence_parallel_encoder(layers[:1], tok, po, rf, shapes, group)
        ((out1 * out1).sum() / (tokens.shape[0] * out1.shape[1] * out1.shape[2])).backward()
        params = dict(layers[0].named_parameters())
        all_reduce_coalesced([p.grad for p in params.values()])
        results.append({"rows": (d * b, (d + 1) * b), "out": out.numpy(),
                        "grads": {k: p.grad.numpy() for k, p in params.items()},
                        "plane": plane.flatten().tolist()})
    return results


# --- rank functions of tests/test_torch_ddp.py ---

def _tensors(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def ddp_step(rank, world, state_dict, batch, points, lr, num_rel, loss_kwargs):
    """One data-parallel train step of the tiny flagship (dropout off) on
    this rank's rows of ``batch``, the mask-cost points drawn for the global
    batch being ``points``: the metrics, the (summed, clipped) gradients,
    the parameters after the step and the Seesaw counts."""
    from pairnet_torch.flagship import flagship
    from pairnet_torch.parallel.mesh import rank_rows
    from pairnet_torch.train import trainer as trainer_mod
    from pairnet_torch.train.optim import build_optimizer

    def global_points(batch_size, n, seed, device):
        assert (batch_size, n) == points.shape[:2], "points are drawn for the global batch"
        return torch.tensor(points)

    model = flagship(tiny=True, device="cpu", relation_ffn_drop=0.0)
    model.load_state_dict(_tensors(state_dict))
    opt = build_optimizer(model, base_lr=lr)
    state = trainer_mod.TrainState(model, opt, num_rel)
    step = trainer_mod.make_train_step(model, opt, loss_kwargs)
    orig, trainer_mod.sample_points = trainer_mod.sample_points, global_points
    try:
        metrics = step(state, _tensors(rank_rows(batch, rank, world)))
    finally:
        trainer_mod.sample_points = orig
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "cum_samples": state.cum_samples.numpy()}


def ddp_nan_guard(rank, world, state_dict, batch, num_rel, loss_kwargs, work_dir):
    """``Trainer.train_epoch`` with the NaN guard on, one batch, where only
    rank 1's loss is NaN: what each rank raised."""
    from pairnet_torch.flagship import flagship
    from pairnet_torch.parallel.mesh import rank_rows
    from pairnet_torch.train import trainer as trainer_mod
    from pairnet_torch.train.optim import build_optimizer

    orig = trainer_mod.get_loss_fn

    def poisoned(*a, **k):
        fn = orig(*a, **k)

        def loss(*la, **lk):
            losses, cum = fn(*la, **lk)
            if rank == 1:
                losses["loss_total"] = losses["loss_total"] * float("nan")
            return losses, cum

        loss.num_points = fn.num_points
        return loss

    model = flagship(tiny=True, device="cpu", relation_ffn_drop=0.0)
    model.load_state_dict(_tensors(state_dict))
    opt = build_optimizer(model)
    trainer_mod.get_loss_fn = poisoned
    try:
        trainer = trainer_mod.Trainer(trainer_mod.TrainState(model, opt, num_rel), work_dir,
                                      loss_kwargs)
    finally:
        trainer_mod.get_loss_fn = orig
    try:
        trainer.train_epoch([rank_rows(batch, rank, world)], 0)
    except FloatingPointError as e:
        return str(e)
    return None


def ddp_train_cli(rank, world, config, work_dir, options):
    """The train CLI on the CPU: ``--max-steps 2``, then ``--resume
    --max-epochs 2``; both summaries and the checkpoints left."""
    from pairnet_torch.tools import train as train_cli

    base = [config, "--device", "cpu", "--work-dir", work_dir]
    first = train_cli.main(base + ["--max-steps", "2", "--cfg-options", *options])
    second = train_cli.main(base + ["--resume", "--max-epochs", "2", "--cfg-options", *options])
    ckpt = torch.load(os.path.join(work_dir, "ckpts", "epoch_1.pt"), map_location="cpu",
                      weights_only=False)["state"]
    return {"first": first, "second": second,
            "ckpts": sorted(os.listdir(os.path.join(work_dir, "ckpts"))),
            "epoch_1": {"step": ckpt["step"], "lrs": [(g["lr"], g["lr_mult"])
                                                      for g in ckpt["optimizer"]["param_groups"]]}}


# --- rank functions of tests/test_torch_parallel_eval.py ---

def image_key(image) -> str:
    """A loader image's identity: the hash of its bytes."""
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()


def planted_apply(planted):
    """``apply_fn`` handing out each image's planted head outputs (numpy,
    batch 1, keyed by :func:`image_key`), whatever the batch it comes in."""
    def apply_fn(images):
        outs = [planted[image_key(img)] for img in images]
        return {k: torch.tensor(np.concatenate([o[k] for o in outs])) for k in outs[0]}

    return apply_fn


def sharded_scoring(rank, world, config, split, planted, kw, results_out, cli_args):
    """The three scoring runners on this rank's shard of the split, with
    planted outputs (``results_out`` written by rank 0), then the scoring
    CLI (sgdet and PQ) on the config's seeded weights."""
    from pairnet_torch.config import load_config
    from pairnet_torch.evaluation import runner
    from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess
    from pairnet_torch.tools import test as test_cli
    from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg

    cfg = load_config(config)
    dataset = build_dataset(cfg, split)
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    apply_fn = planted_apply(planted)
    out = {"sgdet": runner.evaluate_model_device(apply_fn, dataset, pipe_cfg, **kw),
           "pq": runner.evaluate_pq(apply_fn, pairnet_postprocess, dataset, pipe_cfg,
                                    batch_size=kw["batch_size"],
                                    num_classes=cfg.num_object_classes,
                                    num_things=kw["num_things"]),
           "oracle": runner.evaluate_model(apply_fn, dataset, pipe_cfg, results_out=results_out,
                                           **kw)}
    for ev in ("sgdet", "PQ"):
        out[f"cli_{ev}"] = test_cli.main(cli_args + ["--eval", ev])
    return out


def sharded_cli_scoring(rank, world, cli_args, results_out):
    """The scoring CLI on this rank's shard: sgdet with ``--save-results``
    (written by rank 0), then PQ."""
    from pairnet_torch.tools import test as test_cli

    return {"sgdet": test_cli.main(cli_args + ["--eval", "sgdet", "--save-results", results_out]),
            "PQ": test_cli.main(cli_args + ["--eval", "PQ"])}


def _batch_rows(tree, rows):
    """Rows ``rows`` of every array of a nested dict / list, as tensors."""
    if isinstance(tree, dict):
        return {k: _batch_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_batch_rows(v, rows) for v in tree]
    return torch.tensor(np.asarray(tree)[rows])


def zoo_loss_shares(rank, world, cases):
    """Each one-stage head's loss on this rank's rows of the batch with the
    global normalizers (``reduce`` = the all-reduce sum): ``cases`` maps a
    head type to (loss config, outputs, batch, points, cum_samples), numpy.
    Returns per head the losses and the new Seesaw counts."""
    from pairnet_torch.parallel.mesh import all_reduce_sum
    from pairnet_torch.train.dispatch import get_loss_fn

    n = len(next(iter(cases.values()))[3]) // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {}
    for head, (cfg, outputs, batch, points, cum) in cases.items():
        fn = get_loss_fn(head, {"loss": cfg}, reduce=all_reduce_sum)
        losses, new_cum = fn(_batch_rows(outputs, rows), _batch_rows(batch, rows),
                             torch.tensor(points[rows]), torch.tensor(cum))
        out[head] = ({k: float(v) for k, v in losses.items()}, new_cum.numpy())
    return out
