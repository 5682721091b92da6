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
held against the plain reference by the family's ``reference_check``.

Everything particular to the served model (its weights and build, the
boundaries of its stage spans, what a checked request keeps, the check and
the counts from shapes) is its family's: ``portbench/families/<family>.py``,
the configuration's ``family``. A traced run ends with the port's own
spans and counters over the traced requests (``trace.traced_program``).
"""

from __future__ import annotations

import random
import time

import numpy as np

from portbench.harness import Device, Record, SetupParts, Spans


def image_pool(seed, n, batch, hw, dtype, dev: Device):
    """``n`` seeded batches (batch, H, W, 3) of N(0, 1) pixels in ``dtype``,
    made on the device and pinned on the host."""
    import torch

    g = torch.Generator(device=dev.device).manual_seed((int(seed) * 7919 + 17) % 2 ** 63)
    return [dev.pin(torch.randn((batch, *hw, 3), generator=g, device=dev.device)
                    .to(dtype).cpu()) for _ in range(n)]


class Client:
    """The one client. Predictions come back into pinned host buffers,
    one set a image, reused by every request."""

    def __init__(self, model, pool, dev: Device, num_things: int, family):
        self.model, self.pool, self.dev, self.num_things = model, pool, dev, num_things
        self.family, self.host = family, None

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
        of it on the host: the family's ``Taps.keep`` and the predictions,
        ``got``)."""
        from torch.profiler import record_function

        from portbench import sut

        taps = self.family.Taps(self.model) if keep else None
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
        return (begin, end), dict(taps.keep(out),
                                  got=[type(p)(*(t.clone() for t in p)) for p in got])


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Record:
    import torch

    from portbench import sut
    from portbench import trace as tracing

    cfg, mix, family = cell.config, cell.mix, cell.family
    model_cfg, hw, B = cfg["model"], tuple(cfg["image_hw"]), int(mix["batch"])
    dtype = getattr(torch, cfg["serve"]["dtype"])
    dev = Device(device)
    rec = Record(device_kind=dev.name())

    # --- set-up: weights from the seed, the system, the pool, warm-up
    parts = SetupParts(t0, dev)
    weights = family.weights(model_cfg, seed, dev.device, dtype)
    parts.mark("weights")
    sut.import_system()
    parts.mark("system import")
    model = family.build(model_cfg, weights, dev.device, dtype, cfg["serve"]["msda"])
    del weights
    parts.mark("system")
    pool = image_pool(seed, int(mix["pool_requests"]), B, hw, dtype, dev)
    parts.mark("inputs")
    client = Client(model, pool, dev, int(cfg["num_things"]), family)
    for i in range(int(mix["warmup_requests"])):
        client.request(i)
        parts.mark(f"request {i}")
    rec.end_to_end["setup_s"] = parts.done()

    # --- the window
    rng = random.Random(seed)
    keep = set(rng.sample(range(int(mix["check_from"])), int(mix["check_requests"])))
    spans = Spans(dev, model, family.BOUNDARIES) if trace else None
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

        def work():
            for j in range(rec.trace_units):
                client.request(n + j)

        rec.trace = tracing.traced(work, dev.sync)
        rec.program_counts, program = tracing.traced_program(work, dev.sync)
        if rec.trace is not None:
            rec.trace.program = program
    rec.peak_window_bytes = rec.memory_peak_bytes = dev.peak()
    del client, model
    dev.free()

    # --- counts from shapes, then the reference
    rec.counts.update(family.shape_counts(model_cfg, hw, B))
    rec.flops_per_image = rec.counts.pop("flops_per_image")
    rec.checks = family.reference_check(cell, seed, dev, kept, pool)
    return rec
