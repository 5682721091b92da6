"""Train a scene-graph model: the port's counterpart of ``tools/train.py``.

Usage::

    python -m pairnet_torch.tools.train CONFIG [--work-dir D] [--max-steps N]
        [--max-epochs N] [--resume] [--load-from PATH] [--seed S]
        [--cfg-options k=v ...] [--device cpu]
    torchrun --nproc_per_node N -m pairnet_torch.tools.train CONFIG ...

On ``cuda:LOCAL_RANK`` by default. Under ``torchrun`` every rank joins the
default process group (NCCL on CUDA, gloo with ``--device cpu``) and the
step is data parallel (``train/trainer.py``): the global batch is
``data.samples_per_device`` x world size, each rank loading its rows of it;
``config.json``, the logs and the checkpoints come from rank 0. The lr is
``optimizer.lr`` scaled by the global batch /
``optimizer.auto_scale_lr_base_batch`` and stepped by the config's
``schedule``, AdamW with its ``custom_lr_keys``, weight decay and
``grad_clip``, the forward in ``compute_dtype`` (bf16, else f32 masters
only). ``config.json`` is written into the work dir, checkpoints into its
``ckpts/epoch_<n>.pt`` (which ``pairnet_torch.tools.test`` scores). Every head of the port
trains, with its own loss (``train/dispatch.py``); the Seesaw baseline
carries R + 1 Seesaw counts, as JAX's CLI sizes them. A two-stage model
(``SceneGraphTwoStage``) trains on GT boxes with ``data.max_pairs``
(default 256) relation pairs an image sampled by ``to_twostage_batch``.
``--max-steps`` caps the epochs at ceil(max_steps / steps per epoch), as
the JAX CLI does. A run starts at epoch 0 unless ``--resume`` continues
from the newest checkpoint. ``--load-from`` (or the config's ``load_from``)
warm-starts from a reference PyTorch checkpoint ``.pth`` (mmdet's layout,
the Mask2Former segmenter's included), an ``.npz`` of "/"-flattened flax
variables or of a JAX run (``tools/export_orbax.py``), or a port checkpoint
``.pt``; a path that does not exist logs a warning and trains from scratch.
A JAX run is continued, optimizer and all, by ``pairnet_torch.tools.import_jax``
and then ``--resume``. With ``workflow=['train', 'val']`` each epoch ends with a
validation-loss pass on the test split.

Environment, read here: ``PAIRNET_DEFORM_IMPL`` picks the MSDA kernels as
for the test CLI (unset: the exact forward and the bwd2 backward);
``PAIRNET_LOADER_WORKERS`` the loader's threads (default 4);
``PAIRNET_PROFILE_DIR`` and ``PAIRNET_DEBUG_NANS`` are read by the Trainer.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a PSG model")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--max-steps", type=int, default=0, help="cap the epochs to cover N steps")
    p.add_argument("--max-epochs", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest ckpts/epoch_<n>.pt of the work dir")
    p.add_argument("--load-from",
                   help="warm-start weights: a reference .pth, an .npz of flax variables "
                        "(or a tools/export_orbax.py export) or a port .pt")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cfg-options", nargs="+", default=[], help="dotted-path overrides k=v")
    p.add_argument("--device", default=None, help="torch device (default: cuda:LOCAL_RANK)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the config says; returns a summary: the epoch the run
    started at, the epochs, steps per epoch, seconds, the last logged
    metrics and the checkpoints written."""
    args = parse_args(argv)
    from pairnet_torch.parallel.mesh import distributed

    with distributed(args.device) as (rank, world, device):
        return _main(args, rank, world, device)


def build_train_state(cfg, device: torch.device, seed: int, batch_size: int):
    """``(state, base_lr, head_type)``: the config's model with seeded weights,
    its AdamW (the lr scaled by ``batch_size`` /
    ``optimizer.auto_scale_lr_base_batch``, the ``custom_lr_keys`` groups,
    the weight decay) and a :class:`TrainState` with the head's Seesaw count
    size, as this CLI trains them."""
    from pairnet_torch.train.builder import build_detector
    from pairnet_torch.train.dispatch import get_loss_fn
    from pairnet_torch.train.optim import build_optimizer
    from pairnet_torch.train.trainer import TrainState

    head_type = cfg.model["relation_head" if "relation_head" in cfg.model else "bbox_head"].type
    cum_size = get_loss_fn(head_type, cfg).cum_size(cfg.num_relation_classes)
    opt_cfg = cfg.optimizer
    base_lr = opt_cfg.lr
    if opt_cfg.get("auto_scale_lr_base_batch"):
        base_lr = base_lr * batch_size / opt_cfg.auto_scale_lr_base_batch
    model = build_detector(cfg, device=device, seed=seed)
    optimizer = build_optimizer(model, base_lr, weight_decay=opt_cfg.weight_decay,
                                custom_lr_keys=dict(opt_cfg.custom_lr_keys))
    return TrainState(model, optimizer, cum_size, seed=seed), base_lr, head_type


def _main(args, rank: int, world: int, device: torch.device) -> dict:
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(message)s")

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.data.pipeline import Loader
    from pairnet_torch.flagship import set_deform_impl
    from pairnet_torch.tools.test import deform_impl
    from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg
    from pairnet_torch.train.optim import step_lr_schedule
    from pairnet_torch.train.trainer import Trainer
    from pairnet_torch.utils.from_jax import load_pretrained

    cfg = load_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    work_dir = args.work_dir or cfg.work_dir
    os.makedirs(work_dir, exist_ok=True)
    if rank == 0:
        cfg.dump(os.path.join(work_dir, "config.json"))
    seed = args.seed if args.seed is not None else cfg.get("seed", 10086)
    impl = deform_impl("f32")  # unset: the exact kernels, whatever the compute dtype

    dataset = build_dataset(cfg, split="train")
    pipe_cfg = build_pipeline_cfg(cfg, train=True)
    batch_size = cfg.data.samples_per_device * world  # the global batch
    transform = None
    if cfg.model.type == "SceneGraphTwoStage":  # GT boxes and sampled relation pairs
        from pairnet_torch.data.pipeline import to_twostage_batch

        max_pairs = cfg.data.get("max_pairs", 256)

        def transform(s, rng):
            return to_twostage_batch(s, max_pairs, train=True, rng=rng)

    def loader_fn(epoch):
        return Loader(dataset, pipe_cfg, batch_size, train=True, seed=seed + epoch, rank=rank,
                      world=world, sample_transform=transform)

    steps_per_epoch = max(1, len(loader_fn(0)))

    state, base_lr, head_type = build_train_state(cfg, device, seed, batch_size)
    model = set_deform_impl(state.model, impl)
    load_from = args.load_from or cfg.get("load_from")
    if load_from and os.path.exists(load_from):
        load_pretrained(model, load_from)
        logging.info("warm-started weights from %s", load_from)
    elif load_from:
        logging.warning("load_from %s not found; training from scratch", load_from)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("model %s: %.2fM params, %s x %d ranks, MSDA %s, global batch %d, %d "
                 "steps/epoch", cfg.model.type, n_params / 1e6, device, world, impl, batch_size,
                 steps_per_epoch)

    schedule = step_lr_schedule(base_lr, steps_per_epoch, cfg.schedule.decay_epochs,
                                cfg.schedule.gamma)
    compute_dtype = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16}.get(
        cfg.get("compute_dtype") or "")
    trainer = Trainer(state, work_dir, loss_kwargs=dict(cfg.get("loss", {})),
                      log_interval=cfg.get("log_interval", 50),
                      ckpt_interval_epochs=cfg.checkpoint.interval_epochs,
                      max_keep_ckpts=cfg.checkpoint.max_keep, compute_dtype=compute_dtype,
                      schedule=schedule, grad_clip=cfg.optimizer.grad_clip,
                      head_type=head_type)
    max_epochs = args.max_epochs or cfg.schedule.max_epochs
    if args.max_steps:
        max_epochs = min(max_epochs, -(-args.max_steps // steps_per_epoch))

    val_loader_fn = None
    if "val" in cfg.get("workflow", ["train"]):
        # PSG has no separate val split: the test split is the val set
        val_dataset = build_dataset(cfg, split="test")
        val_pipe_cfg = build_pipeline_cfg(cfg, train=False)

        def val_loader_fn(epoch):  # JAX's two-stage val pairs are train-sampled too
            return Loader(val_dataset, val_pipe_cfg, batch_size, train=False, rank=rank,
                          world=world, sample_transform=transform)

    t0 = time.perf_counter()
    last = trainer.fit(loader_fn, max_epochs, val_loader_fn=val_loader_fn, resume=args.resume)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    steps = max(0, max_epochs - trainer.start_epoch) * steps_per_epoch
    logging.info("training done: epochs %d-%d, %d steps in %.2f s: %s", trainer.start_epoch + 1,
                 max_epochs, steps, seconds, last)
    return {"work_dir": work_dir, "rank": rank, "world": world,
            "start_epoch": trainer.start_epoch, "max_epochs": max_epochs,
            "steps_per_epoch": steps_per_epoch, "steps": steps, "seconds": seconds,
            "last": last, "checkpoints": [str(p) for _, p in trainer.checkpoints()]}


if __name__ == "__main__":
    main(sys.argv[1:])
