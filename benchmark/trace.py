"""The benchmark's reading of a profiler trace: a slice of the run under
`torch.profiler` (CPU and CUDA activities), exported as a Chrome trace and reduced here.

Spans are the benchmark's own `record_function` ranges, named `bench.<name>`, that it
opens around the program's calls; `bench.window` covers the whole slice. A device
operation (kernel, copy, set) belongs to a span where the host call that launched it
(the runtime event of the same correlation id) started inside the span on the span's
thread."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

from benchmark.counts.intervals import busy, gaps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@contextlib.contextmanager
def profiled():
    """Profile the block's CPU and CUDA activity inside a `bench.window` range; yields
    a holder whose `.trace` is the parsed `Trace` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"trace": None})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f))
    finally:
        os.unlink(path)


class Trace:
    """Device operations, host events and spans of one exported trace (µs)."""

    def __init__(self, doc: dict):
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.device, self.host, self.spans = [], [], []
        launch = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), float(e.get("dur", 0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, corr))
            elif cat in HOST_CATS:
                self.host.append((e["name"], ts, ts + dur, e.get("tid")))
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    launch[corr] = (ts, e.get("tid"))
                if cat == "user_annotation" and e["name"].startswith("bench."):
                    self.spans.append((e["name"], ts, ts + dur, e.get("tid")))
        self.launch = launch
        windows = [s for s in self.spans if s[0] == WINDOW]
        if not windows:
            raise ValueError("trace: no bench.window range")
        _, self.lo, self.hi, self.tid = windows[0]
        self.device = [d for d in self.device if d[2] > self.lo and d[1] < self.hi]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device inside the window."""
        return busy([(a, b) for _, a, b, _ in self.device], self.lo, self.hi) / 1e6

    def span_ms(self, name: str) -> float | None:
        """Device ms of the operations launched inside the spans called `name`; None
        where the trace has no such span."""
        spans = sorted((a, b, tid) for n, a, b, tid in self.spans if n == name)
        if not spans:
            return None
        starts = [s[0] for s in spans]
        total = 0.0
        for _, a, b, corr in self.device:
            at = self.launch.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at[0]) - 1  # spans of one name never nest
            if i >= 0 and at[0] <= spans[i][1] and spans[i][2] == at[1]:
                total += b - a
        return total / 1e3

    def kernel_ms(self, names) -> float | None:
        """Device ms of the kernels whose name contains one of `names`; None where
        none ran."""
        hits = [b - a for n, a, b, _ in self.device if any(k in n for k in names)]
        return sum(hits) / 1e3 if hits else None

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, a, b, _ in self.device:
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def host_at(self, t: float) -> str:
        """What the host was doing at t: the innermost benchmark span of the window's
        thread there, then the innermost host event of that thread, or where it has none
        (as while it waits for autograd's backward) of any other thread, named by it."""
        span, own, other = None, None, None
        for name, a, b, tid in self.host:
            if not a <= t < b or name == WINDOW:
                continue
            if tid == self.tid and name.startswith("bench."):
                if span is None or a >= span[1]:
                    span = (name, a)
            elif tid == self.tid:
                if own is None or a >= own[1]:
                    own = (name, a)
            elif other is None or a >= other[1]:
                other = (f"{name} (thread {tid})", a)
        parts = [x[0] for x in (span, own or other) if x is not None]
        return " > ".join(parts) if parts else "(outside any host event)"

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest idle gaps, each by what the host was doing as it began."""
        found = sorted(gaps([(a, b) for _, a, b, _ in self.device], self.lo, self.hi),
                       key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at(a), (b - a) / 1e6] for a, b in found]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
