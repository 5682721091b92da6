"""The system under test: the port's Pair-Net built from a configuration
file's ``model`` and loaded with the benchmark's weights by name.

The benchmark takes from the port only its model classes, its serving
entry (``pairnet_torch.bench.serve``), its train step (optimizer, state
and ``make_train_step``) and its MSDA switch. The model is allocated on
``meta`` and filled from the benchmark's tensors (``load_state_dict``,
strict: every name of the reference's specs, and only those).
"""

from __future__ import annotations

import torch


def import_system():
    """Import the port's modules that a run drives."""
    import pairnet_torch.bench  # noqa: F401
    import pairnet_torch.models.frameworks.psgtr  # noqa: F401
    import pairnet_torch.train.trainer  # noqa: F401


def build_model(model_cfg: dict, weights: dict, device, dtype, msda: str):
    """The port's ``PSGTr(backbone, PairNetHead)`` in ``dtype`` on
    ``device``, holding ``weights``, in eval mode, every MSDA on ``msda``."""
    from pairnet_torch.flagship import set_deform_impl
    from pairnet_torch.models.frameworks.psgtr import PSGTr, build_backbone
    from pairnet_torch.models.heads.pairnet_head import PairNetHead

    with torch.device("meta"):
        bb = build_backbone(model_cfg["backbone"])
        model = PSGTr(bb, PairNetHead(bb.out_channels, **model_cfg["head"]))
    model = model.to_empty(device=device).to(dtype)
    model.load_state_dict(weights, strict=True)
    return set_deform_impl(model, msda).eval()


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

    model = build_model(model_cfg, weights, device, torch.float32, train_cfg["msda"])
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

