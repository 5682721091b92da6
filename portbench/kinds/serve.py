"""Serving cells: one client in a closed loop. Each request copies a
pinned host batch of ``batch`` images to the card, runs the port's serving
entry (forward, then the post-processing of every image) and brings every
field of each image's prediction back to the host; the next request starts
when it has. The images are ``pool_requests`` distinct seeded batches,
served in turn.

End-to-end: ``serve_images_per_s``, the images of all requests completed
in the window over the window's seconds (host clock; the window closes
when the request running at its end completes); ``latency_p95_ms``, the
95th percentile over every request of the window of its span on the
device's timeline (CUDA events recorded before the upload and after the
last field reached the host). Traced run: the stage spans of every request
(forward hooks at the port's module boundaries) and a profiled window of
``trace_requests`` requests.

Correctness (after the window, the system freed): a seeded sample of
``check_requests`` of the window's first ``check_from`` requests (or, where
none of them came in time, one more request that closes the window), each
image against the plain reference at float32 with TF32 off (see
:func:`compare`). What the check reads of a kept request (its outputs,
and the decoder's attention masks and the mask features, read by hooks at
the port's module boundaries) is copied to the host after the request's
last event: those copies fall inside the window.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np

from portbench.harness import Device, Record, SetupParts, Spans, no_tf32, rel_err
from portbench.reference import pairnet, post

BOUNDARIES = (("backbone", "backbone"), ("pixel_decoder", "bbox_head.pixel_decoder"),
              ("decoder", "bbox_head.transformer_decoder"), ("pair_head", "bbox_head"))
CLS_KEYS = ("cls", "rel", "sub", "obj")
POST_KEYS = ("cls", "mask", "rel", "sub", "obj", "sub_seg", "obj_seg")


def image_pool(seed, n, batch, hw, dtype, dev: Device):
    """``n`` seeded batches (batch, H, W, 3) of N(0, 1) pixels in ``dtype``,
    made on the device and pinned on the host."""
    import torch

    g = torch.Generator(device=dev.device).manual_seed((int(seed) * 7919 + 17) % 2 ** 63)
    return [dev.pin(torch.randn((batch, *hw, 3), generator=g, device=dev.device)
                    .to(dtype).cpu()) for _ in range(n)]


KEPT = ("cls", "mask", "rel", "importance", "sub", "obj", "sub_seg", "obj_seg", "sub_pos",
        "obj_pos", "queries")


class Client:
    """The one client. Predictions come back into pinned host buffers,
    one set a image, reused by every request."""

    def __init__(self, model, pool, dev: Device, num_things: int):
        self.model, self.pool, self.dev, self.num_things = model, pool, dev, num_things
        self.host = None

    def to_host(self, preds):
        import torch

        shapes = [[(t.shape, t.dtype) for t in p] for p in preds]
        if self.host is None or shapes != [[(b.shape, b.dtype) for b in h] for h in self.host]:
            self.host = [[self.dev.pin(torch.empty(t.shape, dtype=t.dtype)) for t in p]
                         for p in preds]
        for bufs, p in zip(self.host, preds):
            for buf, t in zip(bufs, p):
                buf.copy_(t, non_blocking=True)
        self.dev.sync()
        return [type(p)(*bufs) for p, bufs in zip(preds, self.host)]

    def request(self, i, spans: Spans | None = None, keep: bool = False):
        """Request ``i``: (its two events, with ``keep`` what the check reads
        of it on the host: the head outputs, the predictions, the decoder's
        attention masks and the mask features)."""
        from torch.profiler import record_function

        from portbench import sut

        taps = Taps(self.model) if keep else None
        try:
            with record_function("portbench.request"):
                begin = self.dev.event()
                images = self.pool[i % len(self.pool)].to(self.dev.device, non_blocking=True)
                if spans is not None:
                    spans.start()
                with record_function("portbench.serve"):
                    out, preds = sut.serve(self.model, images, self.num_things)
                with record_function("portbench.to_host"):
                    got = self.to_host(preds)
                end = self.dev.event()
                if spans is not None:
                    spans.mark("postprocess")
        finally:
            if taps is not None:
                taps.close()
        if not keep:
            return (begin, end), None
        kept = {"out": {k: out[k].cpu() for k in KEPT},
                "got": [type(p)(*(t.clone() for t in p)) for p in got],
                "masks": [m.cpu() for m in taps.masks],
                "mask_features": taps.mask_features.cpu()}
        return (begin, end), kept


class Taps:
    """Hooks at the port's module boundaries that keep one request's
    decoder attention masks (the input of each decoder layer) and mask
    features (the pixel decoder's first output)."""

    def __init__(self, model):
        self.masks, self.mask_features, self.handles = [], None, []
        for name, module in model.named_modules():
            if name.startswith("bbox_head.transformer_decoder.layers.") and name.count(".") == 3:
                self.handles.append(module.register_forward_pre_hook(
                    lambda mod, args: self.masks.append(args[4][:, 0].clone())))
        self.handles.append(model.bbox_head.pixel_decoder.register_forward_hook(self._pixel))

    def _pixel(self, mod, args, out):
        self.mask_features = out[0].clone()

    def close(self):
        for h in self.handles:
            h.remove()


MASK_MARGIN = 0.3  # of the layer's logit standard deviation


def mask_flips(record, margin):
    """Share of attention-mask entries where the system decided otherwise
    than the reference's own logit says clearly: beyond ``margin`` of the
    layer's logit standard deviation from 0. A row is masked everywhere, and
    so attends everywhere, where its largest logit is clearly below 0; a
    row whose largest logit is near 0 is not judged."""
    import torch

    bad = total = 0
    for used, lg in record:
        thr = margin * lg.std()
        top = lg.amax(-1, keepdim=True)
        cleared = top < -thr
        expect = (lg < 0) & ~cleared
        judged = ((lg.abs() > thr) | cleared) & (top.abs() > thr)
        bad += int(((used != expect) & judged).sum())
        total += lg.numel()
    return bad / max(total, 1)


def bf16(t):
    return t.bfloat16().float()


def compare(P, model_cfg, images, kept, num_things):
    """The numbers of one kept request (see :class:`Client`). The
    reference replays the system's attention masks and pair picks, and
    holds each decision, and the heads on the system's own features, by
    themselves:

    * ``cls_err``: the largest relative L2 gap of the class and predicate
      logits (cls, rel, sub, obj);
    * ``mask_flips``: see :func:`mask_flips`, at ``MASK_MARGIN``;
    * ``mask_head_err``: the mask logits (mask, sub_seg, obj_seg) against
      the reference's mask head on the system's own final queries and mask
      features;
    * ``importance_x_bf16``: the PPN's importance of the system's own final
      queries against the system's, over what bf16 rounding of the same
      products gives (its queries are near orthogonal in some seeds, where
      any rounding moves the importance far);
    * ``topk_mismatch``: picks whose importance differs from the system's
      own sorted top-k importance values (exact);
    * ``post_mismatch``: the prediction entries that differ from the
      reference post-processing of the system's head outputs (exact; no
      ``got``: not compared).
    """
    import torch

    out, got, masks = kept["out"], kept.get("got"), kept["masks"]
    B = images.shape[0]
    h = model_cfg["head"]
    K, layers = h["num_rel_query"], h["num_decoder_layers"]
    worst = dict.fromkeys(("cls_err", "mask_flips", "mask_head_err", "importance_x_bf16",
                           "topk_mismatch", "post_mismatch"), 0.0)
    if len(masks) != layers:  # the decoder was not driven as its layers' inputs say
        return {k: float("inf") for k in worst}

    def most(key, value):
        worst[key] = max(worst[key], float(value))

    for b in range(B):
        pairs = (out["sub_pos"][b:b + 1], out["obj_pos"][b:b + 1])
        record = []
        ref = pairnet.forward(P, images[b:b + 1].float(), model_cfg, pairs=pairs,
                              masks=[m[b:b + 1] for m in masks], record=record)
        errs = {k: rel_err(out[k][b], ref[k][0]) for k in CLS_KEYS}
        print(f"portbench: image {b}: " + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()),
              file=sys.stderr)
        most("cls_err", max(errs.values()))
        most("mask_flips", mask_flips(record, MASK_MARGIN))
        queries = out["queries"][b:b + 1].float()
        del ref, record
        mask = pairnet.mask_head(P, queries, kept["mask_features"][b:b + 1].float())[0]
        rows = {"mask": mask, "sub_seg": mask[out["sub_pos"][b]],
                "obj_seg": mask[out["obj_pos"][b]]}
        most("mask_head_err", max(rel_err(out[k][b], v) for k, v in rows.items()))
        del mask, rows
        imp = pairnet.pair_importance(P, queries)[0]
        err = rel_err(out["importance"][b], imp)
        err_bf16 = rel_err(pairnet.pair_importance(P, queries, bf16)[0], imp)
        most("importance_x_bf16", err / max(err_bf16, 1e-12))
        Q = out["importance"].shape[-1]
        have = out["importance"][b].flatten()
        picked = have[out["sub_pos"][b] * Q + out["obj_pos"][b]]
        most("topk_mismatch", (picked != have.topk(K).values).sum())
        if got is not None:
            expect = post.triplets({k: out[k][b].float() for k in POST_KEYS}, num_things)
            bad = abs(len(got[b]) - len(expect))
            for have_t, want in zip(got[b], expect):
                want = want.cpu()
                if have_t.shape != want.shape or have_t.dtype != want.dtype:
                    bad += max(have_t.numel(), want.numel())
                else:
                    bad += int((have_t.cpu() != want).sum())
            most("post_mismatch", bad)
    return worst


def reference_check(cell, seed, dev: Device, kept: dict, pool) -> dict:
    """(value, limit) of each number over the kept requests: request ``i``
    of ``kept`` served ``pool[i % len(pool)]``; without ``got`` its
    predictions are not compared."""
    import torch

    from portbench.reference import init

    cfg = cell.config
    model_cfg = cfg["model"]
    dtype = getattr(torch, cfg["serve"]["dtype"])
    with no_tf32(), torch.no_grad():
        P = {k: v.float() for k, v in
             init.make_weights(pairnet.param_specs(model_cfg), seed, dev.device, dtype).items()}
        worst = {}
        for i, k in sorted(kept.items()):
            on_dev = {"out": {n: t.to(dev.device) for n, t in k["out"].items()},
                      "got": k["got"], "masks": [m.to(dev.device) for m in k["masks"]],
                      "mask_features": k["mask_features"].to(dev.device)}
            images = pool[i % len(pool)].to(dev.device)
            for name, v in compare(P, model_cfg, images, on_dev, cfg["num_things"]).items():
                worst[name] = max(worst.get(name, 0.0), v)
            del on_dev
    limits = cfg["limits"]["serve"]
    return {k: (worst[k], float(limits[k])) for k in limits}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Record:
    import torch

    from portbench import sut
    from portbench import trace as tracing
    from portbench.counts import flops, msda
    from portbench.reference import init

    cfg, mix = cell.config, cell.mix
    model_cfg, hw, B = cfg["model"], tuple(cfg["image_hw"]), int(mix["batch"])
    dtype = getattr(torch, cfg["serve"]["dtype"])
    dev = Device(device)
    rec = Record(device_kind=dev.name())

    # --- set-up: weights from the seed, the system, the pool, warm-up
    parts = SetupParts(t0, dev)
    weights = init.make_weights(pairnet.param_specs(model_cfg), seed, dev.device, dtype)
    parts.mark("weights")
    sut.import_system()
    parts.mark("system import")
    model = sut.build_model(model_cfg, weights, dev.device, dtype, cfg["serve"]["msda"])
    del weights
    parts.mark("system")
    pool = image_pool(seed, int(mix["pool_requests"]), B, hw, dtype, dev)
    parts.mark("inputs")
    client = Client(model, pool, dev, int(cfg["num_things"]))
    for i in range(int(mix["warmup_requests"])):
        client.request(i)
        parts.mark(f"request {i}")
    rec.end_to_end["setup_s"] = parts.done()

    # --- the window
    rng = random.Random(seed)
    keep = set(rng.sample(range(int(mix["check_from"])), int(mix["check_requests"])))
    spans = Spans(dev, model, BOUNDARIES) if trace else None
    kept, events = {}, []
    dev.reset_peak()
    start = time.perf_counter()
    deadline = start + seconds
    n = 0
    while True:
        ev, kept[n] = client.request(n, spans, keep=n in keep)
        events.append(ev)
        n += 1
        if time.perf_counter() >= deadline:
            if any(kept.values()):
                break
            keep.add(n)  # none of the sample came in time: the window's last request
    rec.window_s = time.perf_counter() - start
    dev.sync()
    kept = {i: k for i, k in kept.items() if k is not None}
    rec.attempted = n
    rec.images = n * B
    latencies = [dev.ms(a, b) for a, b in events]
    rec.end_to_end["serve_images_per_s"] = rec.images / rec.window_s
    rec.end_to_end["latency_p95_ms"] = float(np.percentile(latencies, 95))
    if spans is not None:
        rec.spans = spans.close()
        rec.trace_units = int(mix["trace_requests"])
        rec.trace = tracing.traced(
            lambda: [client.request(n + j) for j in range(rec.trace_units)], dev.sync)
    rec.peak_window_bytes = rec.memory_peak_bytes = dev.peak()
    del client, model
    dev.free()

    # --- counts from shapes, then the reference
    h = model_cfg["head"]
    shapes = msda.encoder_shapes(hw)
    args = (B, shapes, h["num_heads"], h["embed_dims"] // h["num_heads"], h["num_feat_levels"], 4)
    rec.counts["msda_calls_per_unit"] = h["pixel_decoder_layers"]
    rec.counts["msda_least_s"] = msda.least_seconds(msda.forward_bytes(*args),
                                                    msda.forward_ops(*args))
    rec.flops_per_image = flops.forward_flops_per_image(model_cfg, hw)
    rec.checks = reference_check(cell, seed, dev, kept, pool)
    return rec
