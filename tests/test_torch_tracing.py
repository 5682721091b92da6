"""The port's tracer (``pairnet_torch/utils/tracing.py``): off, a span is
the shared null context and a profiled serve or train step holds no
``pairnet.*`` event; on, every span appears inside its unit, one fusion
span an image and the Hungarian inside the targets; the Hungarian's
search steps counted on the device; ``snapshot()`` reading the ops'
counters as they are; ``bench.span_breakdown``."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_helpers import keep_torch_rng  # noqa: F401  (torch's RNG kept per file)

from pairnet_torch.bench import serve, span_breakdown, train_batch  # noqa: E402
from pairnet_torch.flagship import flagship  # noqa: E402
from pairnet_torch.ops.deform_attn_bwd import deform_attn_bwd  # noqa: E402
from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize  # noqa: E402
from pairnet_torch.ops.hungarian import (  # noqa: E402
    batched_hungarian,
    prepare,
    solve_n_le_m_plain_steps,
)
from pairnet_torch.ops.nms import nms_sorted  # noqa: E402
from pairnet_torch.train.optim import build_optimizer  # noqa: E402
from pairnet_torch.train.trainer import TrainState, make_train_step, to_device  # noqa: E402
from pairnet_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)

HW = (64, 96)
LAYERS = ("backbone", "pixel_decoder", "decoder", "pair_head")
SERVE_SPANS = {"serve", "postprocess", "postprocess.fusion", *LAYERS}
PHASES = ("train.forward", "train.targets", "train.loss", "train.backward", "train.optimizer")
TRAIN_SPANS = {"train.step", "hungarian", *PHASES, *LAYERS}


@pytest.fixture
def tracing_on():
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)


@pytest.fixture(scope="module")
def model():
    return flagship(tiny=True, device="cpu")


@pytest.fixture(scope="module")
def images():
    return torch.randn((2, *HW, 3), generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def train():
    """(step, state, batch): the tiny Pair-Net's train step on a seeded
    batch of 2 (4 segments, 5 relations)."""
    model = flagship(tiny=True, device="cpu", seed=1)
    optimizer = build_optimizer(model)
    state = TrainState(model, optimizer, 5)
    step = make_train_step(model, optimizer, {"num_points": 64})
    batch = train_batch(2, HW, G=4, R=5, seed=0)
    batch["gt_labels"] %= 7
    batch["gt_rels"][..., 2] = np.clip(batch["gt_rels"][..., 2], 1, 4)
    return step, state, to_device(batch, "cpu")


def program_spans(fn):
    """(name without the prefix, start, end) of every ``pairnet.*`` event
    of a CPU profile of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name[len(tracing.PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(tracing.PREFIX)]


def inside(spans, inner, outer):
    """Every ``inner`` span lies inside some ``outer`` span."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    return all(any(a <= s and t <= b for a, b in outs) for n, s, t in spans if n == inner)


def test_off_is_the_shared_null_context():
    assert not tracing.enabled()
    null = tracing.span("backbone")
    assert tracing.span("decoder") is null and tracing.unit("serve") is null
    before = tracing.snapshot()
    with tracing.span("backbone"), tracing.unit("serve"):
        pass
    assert tracing.snapshot() == before  # an off unit counts nothing


def test_off_profile_holds_no_program_span(model, images, train):
    assert program_spans(lambda: serve(model, images, 4)) == []
    step, state, batch = train
    assert program_spans(lambda: step(state, batch)) == []


def test_serve_spans_nest(model, images, tracing_on):
    before = tracing.snapshot()
    spans = program_spans(lambda: serve(model, images, 4))
    counts = tracing.difference(before, tracing.snapshot())
    names = collections.Counter(n for n, _, _ in spans)
    assert set(names) == SERVE_SPANS
    assert names["serve"] == 1 and names["postprocess"] == 1
    assert names["postprocess.fusion"] == images.shape[0]  # one an image
    assert all(names[layer] == 1 for layer in LAYERS)
    for name in SERVE_SPANS - {"serve"}:
        assert inside(spans, name, "serve"), name
    assert inside(spans, "postprocess.fusion", "postprocess")
    assert counts["serve.units"] == 1 and counts["serve.cpu_ns"] > 0


def test_train_spans_nest(train, tracing_on):
    step, state, batch = train
    spans = program_spans(lambda: step(state, batch))
    names = collections.Counter(n for n, _, _ in spans)
    assert set(names) == TRAIN_SPANS
    assert names["train.step"] == 1 and all(names[p] == 1 for p in PHASES)
    for name in TRAIN_SPANS - {"train.step"}:
        assert inside(spans, name, "train.step"), name
    for layer in LAYERS:
        assert inside(spans, layer, "train.forward"), layer
    assert inside(spans, "hungarian", "train.targets")
    starts = [next(a for n, a, _ in spans if n == p) for p in PHASES]
    assert starts == sorted(starts)


def test_hungarian_steps_are_the_plain_solvers(monkeypatch):
    g = torch.Generator().manual_seed(5)
    problems = [(torch.rand((3, 6, 9), generator=g), None),
                (torch.rand((2, 9, 4), generator=g), None),  # n > m: solved transposed
                (torch.randn((4, 5, 7), generator=g), torch.rand((4, 7), generator=g) > 0.3)]
    want = sum(int(solve_n_le_m_plain_steps(prepare(c, col_mask=m)[0])[1].sum())
               for c, m in problems)
    monkeypatch.setattr(batched_hungarian, "steps", 0)
    for cost, mask in problems:  # tracing off: nothing counted
        batched_hungarian(cost, col_mask=mask)
    assert batched_hungarian.steps == 0
    tracing.enable(True)
    try:
        for cost, mask in problems:
            batched_hungarian(cost, col_mask=mask)
    finally:
        tracing.enable(False)
    assert torch.is_tensor(batched_hungarian.steps) and int(batched_hungarian.steps) == want > 0
    assert tracing.snapshot()["batched_hungarian.steps"] == want


def test_snapshot_reads_the_ops_counters(monkeypatch):
    monkeypatch.setattr(int4_gather, "launches", 7)
    monkeypatch.setattr(deform_attn_bwd, "launches", collections.Counter(bf16=3, f32=2))
    monkeypatch.setattr(batched_hungarian, "syncs", 11)
    monkeypatch.setattr(batched_hungarian, "long_launches", 4)
    snap = tracing.snapshot()
    assert snap["int4_gather.launches"] == 7 and int4_gather.launches == 7
    assert snap["deform_attn_bwd.launches.bf16"] == 3 and snap["deform_attn_bwd.launches.f32"] == 2
    assert snap["batched_hungarian.syncs"] == 11 and snap["batched_hungarian.long_launches"] == 4
    for fn in (int4_quantize, batched_hungarian, nms_sorted):
        assert snap[f"{fn.__name__}.launches"] == fn.launches
    assert tracing.difference({"int4_gather.launches": 5}, snap)["int4_gather.launches"] == 2


def test_span_breakdown_on_the_cpu(model, images):
    got = span_breakdown(lambda: serve(model, images, 4), "cpu")
    rows = got["spans"]
    assert set(rows) == SERVE_SPANS and rows["postprocess.fusion"]["calls"] == 2
    assert all(r["host_ms"] > 0 and r["device_ms"] == 0 and r["kernels"] == 0
               for r in rows.values())
    assert rows["serve"]["host_ms"] >= rows["backbone"]["host_ms"]
    assert got["counts"]["serve.units"] == 1
    assert not tracing.enabled()  # left as it was
