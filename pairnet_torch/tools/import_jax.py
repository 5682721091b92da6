"""Make a port checkpoint of a JAX training run.

Usage::

    python tools/export_orbax.py JAX_WORK_DIR --out run.npz     # where JAX is installed
    python -m pairnet_torch.tools.import_jax CONFIG run.npz --work-dir W
        [--cfg-options k=v ...] [--seed S] [--device cpu]

``run.npz`` is an export of a JAX orbax checkpoint (``tools/export_orbax.py``).
The port's training state is built as ``pairnet_torch.tools.train`` builds
it for ``CONFIG`` at world size 1 (the model, AdamW with the config's lr
groups, the Seesaw counts), and the JAX state is carried into it
(``utils/from_jax.load_jax_train_state``): the variables (params,
``constants``, ``batch_stats``), Adam's ``mu``, ``nu`` and ``count``,
``step`` and ``cum_samples``. It is written as ``W/ckpts/epoch_<n>.pt``, ``n``
the orbax step (JAX's epoch), in the ``Trainer``'s format. Then
``python -m pairnet_torch.tools.test CONFIG W`` scores it and
``python -m pairnet_torch.tools.train CONFIG --work-dir W --resume``
continues the run at epoch ``n + 1``.

Not carried: the random streams. JAX's ``rng`` key and the port's generator
draw differently, so the resumed run's mask-cost points and dropout are the
port's own, from its seed.

An export with no optimizer state (a bare ``{"params": variables}``
checkpoint) carries the variables only: the checkpoint it writes holds the
weights and no optimizer state, which the test CLI scores and ``--resume``
refuses, naming what is missing. Runs on the card (default ``cuda``) or
the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Make a port checkpoint of a JAX run's export")
    p.add_argument("config")
    p.add_argument("export", help="the .npz that tools/export_orbax.py wrote")
    p.add_argument("--work-dir", required=True, help="the port run's work dir")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cfg-options", nargs="+", default=[], help="dotted-path overrides k=v")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the checkpoint; returns its path, the epoch and whether it
    carries the optimizer state."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.flagship import resolve_device
    from pairnet_torch.tools.train import build_train_state
    from pairnet_torch.train.trainer import write_checkpoint
    from pairnet_torch.utils.from_jax import (EXPORT_STEP, load_jax_train_state, load_jax_variables,
                                              read_jax_export)

    cfg = load_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    tree, epoch = read_jax_export(args.export)
    if epoch is None:
        raise ValueError(f"{args.export} holds no {EXPORT_STEP}: not an export of "
                         "tools/export_orbax.py (an .npz of flax variables is a --load-from "
                         "warm start)")
    seed = args.seed if args.seed is not None else cfg.get("seed", 10086)
    state, _, _ = build_train_state(cfg, resolve_device(args.device), seed,
                                    cfg.data.samples_per_device)
    full = "opt_state" in tree
    if full:
        load_jax_train_state(state, tree)
        sd = state.state_dict()
    else:
        load_jax_variables(state.model, tree["params"])
        sd = {"step": int(np.asarray(tree.get("step", 0))), "model": state.model.state_dict()}
    os.makedirs(args.work_dir, exist_ok=True)
    cfg.dump(os.path.join(args.work_dir, "config.json"))
    path = write_checkpoint(Path(args.work_dir) / "ckpts" / f"epoch_{epoch}.pt", epoch, sd)
    logging.info("imported %s (epoch %d, step %d, %s) -> %s", args.export, epoch, sd["step"],
                 "with the optimizer state" if full else "weights only", path)
    return {"checkpoint": str(path), "epoch": epoch, "step": sd["step"], "resumable": full}


if __name__ == "__main__":
    main(sys.argv[1:])
