"""Training cells: a closed loop of the port's train step
(``make_train_step``: forward in bf16 over f32 masters, on-device targets
with the Hungarian kernel, losses, backward through the MSDA kernels,
global-norm clip, AdamW) on seeded batches of ``batch`` images cycled from
a pool of ``pool_steps`` distinct ones (the distributions of the port's
training bench: N(0, 1) pixels, ``segments`` segments with random labels
and masks of density 0.2 at a quarter of the resolution, ``relations``
random relations, all valid).

Set-up builds the train state once, seeds its generator from ``--seed``
and drives it through ``checked_steps`` steps on distinct batches through
the same call as the window: they warm every shape up, and the check reads
them. Forward hooks keep each of those steps' decisions (the decoder's
attention masks, the pair picks, the relation decoder's dropout keep masks,
the head outputs); the program's losses, its first gradient as AdamW holds
it (``exp_avg / (1 - beta1)`` after step 1) and each parameter's change
over the steps are read from the step's results and its state.

End-to-end: ``train_images_per_s``, the images of every step completed in
the window over the window's seconds (host clock; the window ends with a
synchronise). Traced run: the step's phases (CUDA events from its
``on_phase`` hook), a profiled window of ``trace_steps`` steps, then the
port's own spans and counters over as many (``trace.traced_program``).

Correctness (after the window, the state freed): the plain reference
(``reference/train.py``) follows the checked steps from the same seeded
weights, replaying the program's decisions and working the targets out
from the program's head outputs with scipy's Hungarian.
"""

from __future__ import annotations

import sys
import time

from portbench.harness import Device, Record, SetupParts, Spans, no_tf32
from portbench.reference import init, pairnet
from portbench.reference import train as ref_train


def batch_pool(seed, n, mix, cfg, dev: Device):
    """``n`` seeded batches on the device."""
    import torch

    B, (H, W) = int(mix["batch"]), cfg["image_hw"]
    G, R = int(mix["segments"]), int(mix["relations"])
    head = cfg["model"]["head"]
    g = torch.Generator(device=dev.device).manual_seed((int(seed) * 6007 + 29) % 2 ** 63)
    d = dev.device
    pool = []
    for _ in range(n):
        pool.append({
            "image": torch.randn((B, H, W, 3), generator=g, device=d),
            "gt_labels": torch.randint(0, head["num_classes"], (B, G), generator=g, device=d,
                                       dtype=torch.int32),
            "gt_masks": torch.rand((B, G, H // 4, W // 4), generator=g, device=d) > 0.8,
            "gt_valid": torch.ones((B, G), dtype=torch.bool, device=d),
            "gt_rels": torch.stack([
                torch.randint(0, G, (B, R), generator=g, device=d),
                torch.randint(0, G, (B, R), generator=g, device=d),
                torch.randint(1, head["num_relations"], (B, R), generator=g, device=d),
            ], -1).to(torch.int32),
            "rel_valid": torch.ones((B, R), dtype=torch.bool, device=d),
        })
    return pool


class Decisions:
    """Forward hooks that keep one step's decisions, moved to the host:
    the decoder layers' attention masks, the relation decoder's dropout
    keep masks, and the head's outputs (pair picks included)."""

    def __init__(self, model):
        self.masks, self.dropout, self.outputs = [], [], {}
        self.handles = []
        for name, m in model.named_modules():
            if name.startswith("bbox_head.transformer_decoder.layers.") and name.count(".") == 3:
                self.handles.append(m.register_forward_pre_hook(
                    lambda mod, args: self.masks.append(args[4][:, 0].cpu())))
            elif (name.startswith("bbox_head.relation_decoder.layers.")
                  and type(m).__name__ == "Dropout"):
                self.handles.append(m.register_forward_hook(
                    lambda mod, args, out: self.dropout.append((out != 0).cpu())))
        self.handles.append(model.bbox_head.register_forward_hook(self._head))

    def _head(self, mod, args, out):
        self.outputs = {k: out[k].detach().float().cpu() for k in
                        ("cls", "mask", "rel", "sub", "obj", "importance")}
        self.outputs.update(sub_pos=out["sub_pos"].cpu(), obj_pos=out["obj_pos"].cpu())

    def close(self):
        for h in self.handles:
            h.remove()
        return {"masks": self.masks, "dropout": self.dropout, "outputs": self.outputs,
                "pairs": (self.outputs["sub_pos"], self.outputs["obj_pos"])}


def step_seeds(seed: int, steps: int):
    """The (points, dropout) seeds the step draws from its generator
    seeded with ``seed``, for each of ``steps`` steps."""
    import torch

    g = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    return [torch.randint(0, 2 ** 62, (2,), generator=g).tolist() for _ in range(steps)]


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Record:
    import torch

    from portbench import sut
    from portbench import trace as tracing
    from portbench.counts import flops, msda

    cfg, mix = cell.config, cell.mix
    model_cfg, tcfg = cfg["model"], cfg["train"]
    B, checked = int(mix["batch"]), int(mix["checked_steps"])
    dev = Device(device)
    rec = Record(device_kind=dev.name())
    specs = pairnet.param_specs(model_cfg)

    # --- set-up: the train state from the seed, the pool, the checked steps
    parts = SetupParts(t0, dev)
    weights = init.make_weights(specs, seed, dev.device, getattr(torch, tcfg["master_dtype"]))
    parts.mark("weights")
    sut.import_system()
    parts.mark("system import")
    active = []  # the Spans that the step's phases mark, in the traced window

    def on_phase(name):
        if active:
            active[0].mark(name)

    step_fn, state, model = sut.train_step(model_cfg, tcfg, weights, dev.device, seed, on_phase)
    del weights
    parts.mark("system")
    pool = batch_pool(seed, int(mix["pool_steps"]), mix, cfg, dev)
    parts.mark("inputs")
    spans = Spans(dev) if trace else None
    if spans is not None:
        active.append(spans)
    decisions, losses = [], []
    params = dict(model.named_parameters())
    tap = sut.TargetsTap()
    for i in range(checked):
        hooks = Decisions(model)
        losses.append(step_fn(state, pool[i % len(pool)])["loss_total"])
        decisions.append(hooks.close())
        if i == 0:  # the first gradient as AdamW holds it, per leaf (none held: 0)
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            held = {n: state.optimizer.state.get(p, {}).get("exp_avg") for n, p in params.items()}
            g1 = {n: 0.0 if m is None else float(m.double().norm()) / (1 - beta1)
                  for n, m in held.items()}
        parts.mark(f"step {i}")
    for d, t in zip(decisions, tap.close()):
        d["targets"] = t
    start = init.make_weights(specs, seed, dev.device, getattr(torch, tcfg["master_dtype"]))
    moved = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
    del start
    losses = [float(x) for x in losses]
    rec.end_to_end["setup_s"] = parts.done()

    # --- the window
    dev.reset_peak()
    begin = time.perf_counter()
    deadline = begin + seconds
    n = 0
    while True:
        if spans is not None:
            spans.start()
        step_fn(state, pool[(checked + n) % len(pool)])
        n += 1
        if time.perf_counter() >= deadline:
            break
    dev.sync()
    rec.window_s = time.perf_counter() - begin
    rec.attempted = n
    rec.images = n * B
    rec.end_to_end["train_images_per_s"] = rec.images / rec.window_s
    if spans is not None:
        rec.spans = spans.close()
        active.clear()
        rec.trace_units = int(mix["trace_steps"])

        def work():
            for j in range(rec.trace_units):
                step_fn(state, pool[j % len(pool)])

        rec.trace = tracing.traced(work, dev.sync)
        rec.program_counts, program = tracing.traced_program(work, dev.sync)
        if rec.trace is not None:
            rec.trace.program = program
    rec.peak_window_bytes = rec.memory_peak_bytes = dev.peak()
    del state, model, params, step_fn
    dev.free()

    # --- counts from shapes, then the reference
    h = model_cfg["head"]
    shapes = msda.encoder_shapes(cfg["image_hw"])
    args = (B, shapes, h["num_heads"], h["embed_dims"] // h["num_heads"], h["num_feat_levels"], 4)
    rec.counts["msda_calls_per_unit"] = h["pixel_decoder_layers"]
    rec.counts["msda_least_s"] = msda.least_seconds(msda.backward_bytes(*args),
                                                    msda.backward_ops(*args))
    rec.flops_per_image = flops.forward_flops_per_image(model_cfg, cfg["image_hw"])
    rec.counts["passes"] = 3.0  # forward and backward
    rec.checks = reference_check(cell, seed, dev, pool, decisions, losses, g1, moved)
    return rec


def follow(cell, seed, dev: Device, pool, decisions):
    """The reference's losses, first clipped gradient norms and parameter
    changes over the checked steps, replaying ``decisions``."""
    import torch

    cfg = cell.config
    model_cfg, tcfg = cfg["model"], cfg["train"]
    specs = pairnet.param_specs(model_cfg)
    names, no_decay = ref_train.trainable(specs)
    P = {k: v.float() for k, v in
         init.make_weights(specs, seed, dev.device, getattr(torch, tcfg["master_dtype"])).items()}
    P0 = {n: P[n].clone() for n in names}
    opt = ref_train.AdamW(names, no_decay)
    cum = torch.zeros(model_cfg["head"]["num_relations"], device=dev.device)
    num_points = int(tcfg["loss"]["num_points"])
    losses, g1, gap, bad = [], None, 0.0, 0
    for i, (d, (points_seed, _)) in enumerate(zip(decisions, step_seeds(seed, len(decisions)))):
        batch = pool[i % len(pool)]
        B = batch["image"].shape[0]
        points = torch.rand((B, num_points, 2), device=dev.device,
                            generator=torch.Generator(device=dev.device).manual_seed(points_seed))
        on_dev = {"masks": [m.to(dev.device) for m in d["masks"]],
                  "dropout": [m.to(dev.device) for m in d["dropout"]],
                  "pairs": tuple(p.to(dev.device) for p in d["pairs"]),
                  "targets": {k: v.to(dev.device) for k, v in d["targets"].items()}}
        with torch.no_grad():
            outputs = {k: v.to(dev.device) for k, v in d["outputs"].items()}
            g, n_bad = ref_train.check_targets(outputs, batch, points, on_dev["targets"])
        gap, bad = max(gap, g), bad + n_bad
        loss, grads, cum, _ = ref_train.step(P, opt, batch, on_dev, model_cfg, cum)
        losses.append(loss)
        if i == 0:
            g1 = {n: float(grads[n].double().norm()) for n in names}
        del grads, on_dev, outputs
    moved = {n: float((P[n] - P0[n]).double().norm()) for n in names}
    return losses, g1, moved, gap, bad


def reference_check(cell, seed, dev: Device, pool, decisions, losses, g1, moved) -> dict:
    """(value, limit) of each number: those of :func:`step_numbers`, and
    ``assign_gap`` and ``targets_mismatch``, the program's targets held by
    themselves (:func:`reference.train.check_targets`)."""
    with no_tf32():
        ref_losses, ref_g1, ref_moved, assign_gap, bad = follow(cell, seed, dev, pool,
                                                                decisions)
    numbers, moving = step_numbers(losses, g1, moved, ref_losses, ref_g1, ref_moved)
    numbers.update(assign_gap=assign_gap, targets_mismatch=float(bad))
    print(f"portbench: losses {losses}, reference {ref_losses}; leaves {len(ref_g1)}, "
          f"of which moving {len(moving)}", file=sys.stderr)
    limits = cell.config["limits"]["train"]
    return {k: (numbers[k], float(limits[k])) for k in limits}


def step_numbers(losses, g1, moved, ref_losses, ref_g1, ref_moved):
    """(``loss_gap``, the worst step's relative loss gap; ``grad_gap``, the
    worst leaf's gap of first-gradient norms; ``update_gap_median``, the
    median leaf's gap of the norms of the change over the steps, among the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's, since the others move under Adam by round-off; those leaves).
    The worst leaf's change swings from run to run (the PPN's sub/obj MLPs,
    whose gradients are small and ill-conditioned through near-orthogonal
    embeddings), so the median leaf's is compared; the five worst leaves of
    each go to standard error."""
    import numpy as np

    names = sorted(ref_g1)
    med = float(np.median([ref_g1[n] for n in names]))
    moving = [n for n in names if ref_g1[n] >= 1e-3 * med]
    numbers = {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses)),
        "grad_gap": gap_of_norms(g1, ref_g1, names),
        "update_gap_median": gap_of_norms(moved, ref_moved, moving, np.median),
    }
    for what, have, want, keys in (("gradient", g1, ref_g1, names),
                                   ("change", moved, ref_moved, moving)):
        m = float(np.median([want[n] for n in keys]))
        worst = sorted(keys, key=lambda n: -abs(have[n] - want[n]) / max(want[n], m, 1e-30))
        print(f"portbench: worst leaves of the {what} (have, reference, reference "
              f"gradient; median {m:.4g}; worst gap {gap_of_norms(have, want, keys):.4g}): "
              + "; ".join(f"{n} {have[n]:.4g} {want[n]:.4g} {ref_g1[n]:.4g}"
                          for n in worst[:5]), file=sys.stderr)
    return numbers, moving


def gap_of_norms(have: dict, want: dict, names, reduce=max) -> float:
    """The worst leaf's (or with ``reduce``, e.g. the median, that leaf's)
    |have - want| over the larger of ``want`` and the median of ``want``
    over ``names`` (norms given per leaf)."""
    import numpy as np

    if not names:
        return 0.0
    med = float(np.median([want[n] for n in names]))
    return float(reduce([abs(have[n] - want[n]) / max(want[n], med, 1e-30) for n in names]))
