"""The controls of the cells' check: the plain reference put in the
system's place, with the operands of every product rounded to fp8 (e4m3,
one scale a tensor: the step below the configuration's bf16), or for
training a planted fault instead. The cell's own check (its family's or
its kind's ``reference_check``, the limits of the configuration,
``Record.correct``) then judges it as it judges the system: the float32
reference replays the stand-in's decisions. Run on the card at the cell's
own size::

    python3 -m portbench.control --workload pairnet_r50.serve_b8 --seeds 11 12 13

It prints one JSON line a seed: ``correct`` (which a control has to read
false) and each number beside its limit. A serving stand-in (the family's
``stand_in``) serves the first request of the seed's pool; its
post-processing is the reference's own, so its predictions are not
compared. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.harness import Device, Record, no_tf32


def fp8(t):
    """``t`` rounded to fp8 e4m3 with one scale for the tensor; the
    gradient passes through unchanged (the backward's products then read
    the rounded operands)."""
    import torch

    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0  # e4m3's largest finite value
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return rounded + (t - t.detach())


def serve_record(cell, seed: int, device, rnd=fp8) -> Record:
    """The serving check of the first request of ``seed`` with the plain
    reference, its products rounded by ``rnd``, in the system's place."""
    import torch

    from portbench.kinds import serve

    cfg, mix = cell.config, cell.mix
    dtype = getattr(torch, cfg["serve"]["dtype"])
    dev = Device(device)
    pool = serve.image_pool(seed, 1, int(mix["batch"]), tuple(cfg["image_hw"]), dtype, dev)
    images = [img[None] for img in pool[0].to(dev.device)]
    kept = cell.family.stand_in(cell, seed, dev, images, rnd)
    return Record(checks=cell.family.reference_check(cell, seed, dev, kept, images))


def swapped(cost, valid=None):
    """scipy's assignment with the columns of its first two matched rows
    exchanged: a Hungarian that returns a matching that is not the least."""
    from portbench.reference.train import assign

    row2col, col2row = assign(cost, valid)
    rows = [r for r in range(len(row2col)) if row2col[r] >= 0][:2]
    if len(rows) == 2:
        a, b = rows
        row2col[a], row2col[b] = row2col[b], row2col[a]
        col2row[row2col[a]], col2row[row2col[b]] = a, b
    return row2col, col2row


FAULTS = {"fp8": "fp8 e4m3", "half": "half of the batch in the loss",
          "swap": "two matches of each assignment exchanged"}


def train_record(cell, seed: int, device, fault: str = "fp8") -> Record:
    """The training check of ``seed``'s checked steps with the plain
    reference in the system's place, rounded to fp8 (the control) or with
    a planted fault (``FAULTS``): its own dropout and targets are the
    decisions that the float32 reference replays and holds by themselves."""
    import torch

    from portbench.kinds import train
    from portbench.reference import init, pairnet
    from portbench.reference import train as ref_train

    cfg, mix = cell.config, cell.mix
    model_cfg, tcfg = cfg["model"], cfg["train"]
    dev = Device(device)
    steps = int(mix["checked_steps"])
    pool = train.batch_pool(seed, steps, mix, cfg, dev)
    specs = pairnet.param_specs(model_cfg)
    names, no_decay = ref_train.trainable(specs)
    start = init.make_weights(specs, seed, dev.device, getattr(torch, tcfg["master_dtype"]))
    P = {k: v.float().clone() for k, v in start.items()}
    opt = ref_train.AdamW(names, no_decay)
    cum = torch.zeros(model_cfg["head"]["num_relations"], device=dev.device)
    generator = torch.Generator(device=dev.device).manual_seed(int(seed) % 2 ** 63)
    decisions, losses, g1 = [], [], None
    with no_tf32():
        for i, (points_seed, _) in enumerate(train.step_seeds(seed, steps)):
            batch = pool[i]
            B = batch["image"].shape[0]
            points = torch.rand((B, int(tcfg["loss"]["num_points"]), 2), device=dev.device,
                                generator=torch.Generator(device=dev.device)
                                .manual_seed(points_seed))
            loss, grads, cum, d = ref_train.step(
                P, opt, batch, None, model_cfg, cum, rnd=fp8 if fault == "fp8" else pairnet.identity,
                points=points, generator=generator, loss_rows=B // 2 if fault == "half" else None,
                solve=swapped if fault == "swap" else None)
            losses.append(loss)
            decisions.append(d)
            if i == 0:
                g1 = {n: float(grads[n].double().norm()) for n in names}
            del grads
    moved = {n: float((P[n] - start[n].float()).double().norm()) for n in names}
    del P, opt, start
    return Record(checks=train.reference_check(cell, seed, dev, pool, decisions, losses, g1,
                                               moved))


def main(argv=None) -> int:
    from portbench.registry import Bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default="fp8",
                    help="training: the control (fp8) or a planted fault in the system's place")
    args = ap.parse_args(argv)
    cell = Bench().cell(args.workload)
    for seed in args.seeds:
        if cell.mix["kind"] == "train":
            what, rec = FAULTS[args.fault], train_record(cell, seed, "cuda:0", args.fault)
        else:
            what, rec = "fp8 e4m3", serve_record(cell, seed, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": what,
                          "correct": rec.correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in rec.checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
