"""The readers of the program's own spans (`benchmark/program_spans.py` and the metrics
that use it) on synthetic Chrome traces: a backward span on one thread with launches
from another, an idle gap half inside a span, nested stage spans, and a trace without
program spans."""

import pytest

from benchmark.harness import Bench, Run
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace

BENCH = Bench(REPO)
NEW = ("text_idle_ms.synth", "text_idle_ms.long", "gen_pre_tail_ms.synth",
       "backward_ms.train", "backward_idle_ms.train")


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=1):
    return _ev("user_annotation", name, ts, dur, tid)


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(ts, dur, corr, name="k"):
    return _ev("kernel", name, ts, dur, tid=7, corr=corr)


def _read(metric, events, units=1):
    run = Run(trace=Trace({"traceEvents": [_span("bench.window", 0, 1000)] + events}),
              sliced=[{}] * units)
    return BENCH.metric_module(metric).read(run)


def test_backward_launched_from_another_thread_counts_by_time():
    # the step's thread (1) waits in d_backward over [100, 300); autograd's thread (2)
    # launches k1 inside it and k3 after it; thread 1 launches k2 inside it
    ev = [_span("tts.train.step#4", 50, 600), _span("tts.train.d_backward", 100, 200),
          _launch(120, 1, tid=2), _kernel(130, 40, 1),
          _launch(200, 2), _kernel(210, 20, 2),
          _launch(350, 3, tid=2), _kernel(360, 30, 3),
          _span("tts.train.gt_backward", 400, 100), _launch(410, 4, tid=2),
          _kernel(420, 50, 4)]
    assert _read("backward_ms.train", ev, units=2) == pytest.approx((40 + 20 + 50) / 2e3)
    # idle inside [100, 300): [100, 130), [170, 210), [230, 300); inside [400, 500):
    # [400, 420), [470, 500)
    assert _read("backward_idle_ms.train", ev, units=2) == pytest.approx(
        (30 + 40 + 70 + 20 + 30) / 2e3)


def test_idle_gap_half_inside_a_span_counts_its_inside_half():
    # the card runs [0, 100) and [300, 400); tts.text covers [200, 350): idle inside is
    # [200, 300), the gap's second half; the span on another thread is not the window's
    ev = [_kernel(0, 100, 1), _kernel(300, 100, 2), _launch(0, 1), _launch(290, 2),
          _span("tts.infer#1", 150, 300), _span("tts.text", 200, 150),
          _span("tts.text", 500, 100, tid=3)]
    assert _read("text_idle_ms.synth", ev) == pytest.approx(0.1)
    assert _read("text_idle_ms.long", ev, units=2) == pytest.approx(0.05)


def test_stage_spans_nested_in_windows_leave_the_last_stage_out():
    ev = [_span("tts.infer#7", 10, 900), _span("tts.gen", 20, 800)]
    corr = 0
    for w0 in (30, 430):  # two windows, each pre and stages 0-3
        ev.append(_span("tts.gen.window", w0, 380))
        for j, name in enumerate(("tts.gen.pre", "tts.gen.stage0", "tts.gen.stage1",
                                  "tts.gen.stage2", "tts.gen.stage3")):
            t0 = w0 + 10 + 70 * j
            corr += 1
            ev += [_span(name, t0, 60), _launch(t0 + 5, corr),
                   _kernel(t0 + 10, 10 * (j + 1), corr)]
    # per window: pre 10, stages 0-2 20 + 30 + 40; stage 3 (50) is the last
    assert _read("gen_pre_tail_ms.synth", ev, units=2) == pytest.approx(0.1)


@pytest.mark.parametrize("metric", NEW)
def test_a_trace_without_program_spans_reads_none(metric):
    ev = [_span("bench.text_model", 10, 100), _span("bench.generator", 200, 100),
          _launch(20, 1), _kernel(30, 40, 1), _launch(210, 2), _kernel(220, 50, 2)]
    assert _read(metric, ev) is None
