"""The program-span summarizer (``portbench/program.py``) on a hand-built
trace, its readers, and traced runs with the port's spans on at tiny
sizes."""

import time
from types import SimpleNamespace

import pytest

from portbench import harness, program
from portbench.registry import Bench
from portbench.run import run_cell

PROGRAM_SOURCES = ("program_span", "program_counter")


def program_metrics(per_layer, moves=None):
    """The metrics read from the port's own spans and counters."""
    return [m["name"] for m in per_layer
            if m["source"] in PROGRAM_SOURCES and moves in (None, m["moves"])]


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def call(name, ts, corr=None, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0, "pid": 1,
            "tid": tid, "args": {} if corr is None else {"correlation": corr}}


def device(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


# one request [0, 100]: the backbone [10, 50], the post-processing [60, 95]
# and its fusion [70, 90]; the device busy over [0, 20], [40, 65], [85, 100],
# so idle over [20, 40] (backbone) and [65, 85] (5 in the post-processing's
# own time, 15 in the fusion); after the request, harness work
EVENTS = [
    span("pairnet.serve", 0, 100), span("pairnet.backbone", 10, 40),
    span("pairnet.postprocess", 60, 35), span("pairnet.postprocess.fusion", 70, 20),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "pairnet.serve", "ts": 0, "dur": 100,
     "pid": 0, "tid": 7},
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 12, "id": 1, "pid": 1, "tid": 2},
    device(0, 20, 9), call("cudaLaunchKernel", 5, 9),
    call("cudaLaunchKernel", 12, 1, tid=2),  # the autograd thread: attributed by time
    device(40, 25, 1),
    {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 75, "dur": 1.0,
     "pid": 1, "tid": 1, "args": {"correlation": 2}},
    device(85, 15, 2), call("cudaStreamSynchronize", 80), call("cudaMemcpyAsync", 62, 3),
    # outside every unit: left out
    span("pairnet.hungarian", 110, 10), call("cudaStreamSynchronize", 105),
    call("cudaLaunchKernel", 125, 4), device(130, 10, 4),
]


@pytest.fixture(scope="module")
def summary():
    return program.summarize(EVENTS)


def test_units_and_calls(summary):
    assert summary.units == 1
    assert {n: r.calls for n, r in summary.spans.items()} == {
        "serve": 1, "backbone": 1, "postprocess": 1, "postprocess.fusion": 1, "hungarian": 1}
    assert summary.spans["serve"].host_ms == pytest.approx(0.1)


def test_idle_split_across_nested_spans(summary):
    s = summary.spans
    assert s["serve"].idle_ms == pytest.approx(0.040)
    assert s["backbone"].idle_ms == pytest.approx(0.020)
    assert s["postprocess"].idle_ms == pytest.approx(0.020)
    assert s["postprocess"].self_idle_ms == pytest.approx(0.005)
    assert s["postprocess.fusion"].idle_ms == pytest.approx(0.015)
    assert s["serve"].self_idle_ms == pytest.approx(0.0)
    assert s["hungarian"].idle_ms == 0.0  # outside the unit: the harness's


def test_launches_and_syncs_per_innermost_span(summary):
    s = summary.spans
    assert (s["serve"].launches, s["serve"].syncs) == (3, 1)
    assert (s["serve"].self_launches, s["serve"].self_syncs) == (1, 0)
    assert (s["backbone"].launches, s["backbone"].self_launches) == (1, 1)
    assert (s["postprocess"].launches, s["postprocess"].self_launches) == (1, 0)
    assert (s["postprocess.fusion"].self_launches, s["postprocess.fusion"].self_syncs) == (1, 1)
    assert (s["hungarian"].launches, s["hungarian"].syncs) == (0, 0)


def test_device_time_by_the_launching_call(summary):
    s = summary.spans
    assert s["backbone"].device_ms == pytest.approx(0.025)  # launched on another thread
    assert s["postprocess.fusion"].device_ms == pytest.approx(0.015)
    assert s["serve"].device_ms == pytest.approx(0.060) and s["serve"].kernels == 3
    assert s["hungarian"].device_ms == 0.0


def test_no_unit_no_summary():
    assert program.summarize([e for e in EVENTS if e.get("name") != "pairnet.serve"]) is None
    assert program.summarize([]) is None


def test_readers(summary):
    bench = Bench()
    counts = {"serve.units": 4, "serve.cpu_ns": 8_000_000, "batched_hungarian.steps": 40,
              "train.step.units": 0}
    rec = SimpleNamespace(trace=SimpleNamespace(program=summary), program_counts=counts)
    assert len(program_metrics(bench.spec["per_layer"])) == 19
    got = {m: bench.reader(m)(rec)
           for m in program_metrics(bench.spec["per_layer"], "latency_p95_ms")}
    assert len(got) == 8
    assert got["launches.latency"] == 3 and got["host_syncs.latency"] == 1
    assert got["host_cpu_ms.latency"] == pytest.approx(2.0)
    assert got["backbone_idle_ms.latency"] == pytest.approx(0.02)
    assert got["postprocess_idle_ms.latency"] == pytest.approx(0.02)
    assert got["decoder_idle_ms.latency"] is None  # no such span in this trace
    assert bench.reader("hungarian_steps.train")(rec) == 10
    # a record without the program's figures (the parent's) reads nothing
    bare = harness.Record()
    assert all(bench.reader(m)(bare) is None for m in program_metrics(bench.spec["per_layer"]))


@pytest.mark.parametrize("cell,trace", [("tiny_r50.train_b4", True),
                                        ("tiny_r50.serve_b1", True),
                                        ("tiny_r50.serve_b1", False)])
def test_run_with_the_spans_on(tiny_root, monkeypatch, cell, trace):
    """A CPU run: with ``--trace 1`` the port's tracer is on for the passes
    after the traced window and off after them, the counts come from it,
    and each program metric of the cell reads a number or nothing; with
    ``--trace 0`` the tracer is never switched and nothing is counted."""
    from pairnet_torch.utils import tracing

    switched = []
    enable = tracing.enable
    monkeypatch.setattr(tracing, "enable", lambda on: switched.append(on) or enable(on))
    bench = Bench(tiny_root)
    result, rec = run_cell(bench, cell, 2 ** 31 + 9, 0.3, trace, "cpu", t0=time.perf_counter())
    assert result["correct"] is True and not tracing.enabled()
    names = program_metrics(bench.cell(cell).per_layer)
    if not trace:
        assert switched == [] and rec.program_counts == {}
        assert not set(names) & set(result["metrics"])
        return
    assert switched == [True, False]
    unit = "train.step" if "train" in cell else "serve"
    assert rec.program_counts[f"{unit}.units"] == rec.trace_units
    assert program.unit_cpu_ms(rec) > 0
    if unit == "train.step":
        assert program.per_unit_count(rec, "batched_hungarian.steps") > 0
    assert program.of(rec) is None  # the CPU's trace holds no device record
    assert len(names) == 8
    for name in names:
        value = bench.reader(name)(rec)
        assert value is None or isinstance(value, (int, float)), name
    host_cpu = "host_cpu_ms.train" if unit == "train.step" else "host_cpu_ms.latency"
    assert result["metrics"][host_cpu]["value"] > 0
