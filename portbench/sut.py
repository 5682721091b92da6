"""The system under test: the port's entries that a run drives.

The benchmark takes from the port only its model classes and MSDA switch
(through a family's ``build``, ``portbench/families/``), its serving entry
(``pairnet_torch.bench.serve``), its train step (optimizer, state and
``make_train_step``) and, in a traced run, its tracer
(``pairnet_torch.utils.tracing``: its spans and counters).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def import_system():
    """Import the port's modules that a run drives."""
    import pairnet_torch.bench  # noqa: F401
    import pairnet_torch.models.frameworks.psgtr  # noqa: F401
    import pairnet_torch.train.trainer  # noqa: F401


@contextmanager
def tracer():
    """The port's spans and counters on inside the block, off after it."""
    from pairnet_torch.utils import tracing

    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)


def snapshot() -> dict:
    """The port's counters so far (``tracing.snapshot()``); it reads the
    counts kept on the device to the host, so take it outside a timed span."""
    from pairnet_torch.utils import tracing

    return tracing.snapshot()


def counts_since(before: dict) -> dict:
    """The growth of the port's counters since the snapshot ``before``."""
    from pairnet_torch.utils import tracing

    return tracing.difference(before, tracing.snapshot())


def serve(model, images, num_things: int):
    """The port's serving entry: (head outputs, one prediction per image)."""
    from pairnet_torch.bench import serve as port_serve

    return port_serve(model, images, num_things)


def train_step(model_cfg: dict, train_cfg: dict, weights: dict, device, seed: int, on_phase):
    """(the port's train step, its train state, the model): the float32
    masters holding ``weights``, the port's AdamW, a state whose generator
    is seeded with ``seed``, and ``make_train_step`` with the
    configuration's loss options and compute type; ``on_phase(name)`` is
    called at the end of each phase of a step."""
    from pairnet_torch.train.optim import build_optimizer
    from pairnet_torch.train.trainer import TrainState, make_train_step

    from portbench.families import pairnet

    model = pairnet.build(model_cfg, weights, device, torch.float32, train_cfg["msda"])
    optimizer = build_optimizer(model)
    state = TrainState(model, optimizer, model_cfg["head"]["num_relations"],
                       seed=int(seed) % 2 ** 63)
    step = make_train_step(model, optimizer, dict(train_cfg["loss"]),
                           getattr(torch, train_cfg["compute_dtype"]), on_phase=on_phase)
    return step, state, model


class TargetsTap:
    """Keeps the targets of each train step while open: the port's step
    builds them with ``pairnet_torch.train.trainer.pairnet_targets``, which
    this wraps (and restores on ``close``). The reference replays them and
    holds them against its own assignment by themselves."""

    FIELDS = ("r_labels", "r_weights", "sub_ids", "obj_ids", "gt_importance", "query2gt")

    def __init__(self):
        import pairnet_torch.train.trainer as trainer

        self.trainer, self.orig, self.kept = trainer, trainer.pairnet_targets, []

        def tap(outputs, batch, points):
            t = self.orig(outputs, batch, points)
            self.kept.append({f: getattr(t, f).cpu() for f in self.FIELDS})
            return t

        trainer.pairnet_targets = tap

    def close(self):
        self.trainer.pairnet_targets = self.orig
        return self.kept

