#!/usr/bin/env python
"""Export a JAX orbax checkpoint as one ``.npz`` that the PyTorch port reads.

Usage::

    python tools/export_orbax.py WORK_DIR --out run.npz [--step N]

``WORK_DIR`` is a training run's work dir (its ``ckpts/``, as
``tools/train.py`` writes them) or a checkpoint directory itself (what a
config's ``load_from`` names). The newest step, or ``--step``, is restored
target-free, as ``tools/test.py`` restores it: a ``Trainer`` checkpoint is
the whole ``TrainState`` (``params`` the variables dict, ``opt_state``,
``step``, ``cum_samples``, ``rng``), and a bare ``{"params": variables}`` one
is taken too. Every array leaf is written under its "/"-joined path, list
indices as digits (``opt_state/1/0/mu/...``); None leaves (optax's empty
states) are dropped; the orbax step, JAX's epoch, is stored as
``__step__``.

Runs where JAX and orbax are installed; it imports neither the JAX package
nor torch. The port then reads the file: ``python -m
pairnet_torch.tools.import_jax CONFIG run.npz --work-dir W`` makes a port
checkpoint of it, and ``--load-from run.npz`` warm-starts from its
variables.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

STEP_KEY = "__step__"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export an orbax checkpoint as an .npz")
    p.add_argument("checkpoint", help="work dir holding ckpts/, or a checkpoint directory")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", type=int, default=None, help="the step to export (default: newest)")
    return p.parse_args(argv)


def flatten(tree, prefix="") -> dict:
    """The array leaves of nested dicts, lists and tuples under "/"-joined
    paths; None leaves are dropped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def restore(checkpoint: str, step: int | None = None):
    """``(step, raw tree)`` of a checkpoint directory, restored target-free."""
    import orbax.checkpoint as ocp

    root = os.path.abspath(checkpoint)
    if os.path.isdir(os.path.join(root, "ckpts")):
        root = os.path.join(root, "ckpts")
    mgr = ocp.CheckpointManager(root)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    return step, mgr.restore(step, args=ocp.args.StandardRestore())


def main(argv=None) -> str:
    args = parse_args(argv)
    step, raw = restore(args.checkpoint, args.step)
    flat = flatten(raw)
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"{args.checkpoint}: step {step} holds no params")
    flat[STEP_KEY] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    print(f"exported step {step}: {len(flat) - 1} arrays -> {args.out}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
