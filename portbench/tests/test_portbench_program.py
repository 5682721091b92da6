"""The program-span summarizer (``portbench/program.py``) on a hand-built
trace, its readers, and a run with the port's spans on at tiny sizes."""

from types import SimpleNamespace

import pytest

from portbench import harness, program
from portbench import trace as trace_mod
from portbench.registry import Bench


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
    got = {m: bench.reader(m)(rec) for m in program.NEW_METRICS["latency_p95_ms"]}
    assert got["launches.latency"] == 3 and got["host_syncs.latency"] == 1
    assert got["host_cpu_ms.latency"] == pytest.approx(2.0)
    assert got["backbone_idle_ms.latency"] == pytest.approx(0.02)
    assert got["postprocess_idle_ms.latency"] == pytest.approx(0.02)
    assert got["decoder_idle_ms.latency"] is None  # no such span in this trace
    assert bench.reader("hungarian_steps.train")(rec) == 10
    # a record without the program's figures (the parent's) reads nothing
    bare = harness.Record()
    for metrics in program.NEW_METRICS.values():
        assert all(bench.reader(m)(bare) is None for m in metrics)


@pytest.mark.parametrize("cell,trace", [("tiny_r50.train_b4", False),
                                        ("tiny_r50.serve_b1", True)])
def test_run_with_the_spans_on(tiny_root, cell, trace):
    """A CPU run: the window's counts come from the port's tracer, and the
    harness's calls are its own again after the run."""
    from pairnet_torch.utils import tracing

    orig = (harness.Device.reset_peak, harness.Device.peak, trace_mod.traced,
            trace_mod.summarize)
    result, rec, figures = program.traced_run(Bench(tiny_root), cell, 2 ** 31 + 9, 0.3, trace,
                                              True, "cpu")
    assert result["correct"] is True and not tracing.enabled()
    assert (harness.Device.reset_peak, harness.Device.peak, trace_mod.traced,
            trace_mod.summarize) == orig
    unit = "train.step" if "train" in cell else "serve"
    assert rec.program_counts[f"{unit}.units"] == rec.attempted
    assert figures["process_cpu_ms_per_unit"] > 0
    assert program.unit_cpu_ms(rec) > 0
    if unit == "train.step":
        assert program.per_unit_count(rec, "batched_hungarian.steps") > 0
    assert program.of(rec) is None  # the CPU's trace holds no device record
