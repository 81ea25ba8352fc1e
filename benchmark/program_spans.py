"""The program's own spans in a traced slice, for the metric readers that read them.

The port opens them itself (`ttscube_tpu_torch/utils/profiling.span`) while a profiler
records: `record_function` ranges named `tts.<layer>[.<part>]`, the top span of a unit
with the unit's identifier after `#` (`tts.infer#12`), nested on the thread that opened
them. Nothing is patched for them: they are read from the trace's host events on the
window's thread (`Trace.host`, `Trace.tid`), matched by name up to `#`. They carry the
profiler's clock, the clock of the device operations in the same trace, so a device
operation's launch and an idle gap of the card can be placed inside them. A program
that opens no such span gives None."""

from __future__ import annotations

import bisect
import re

from benchmark.counts.intervals import gaps, union

STAGE = re.compile(r"^tts\.gen\.stage(\d+)$")


def spans(trace, names) -> list:
    """(start, end) of the spans on the window's thread whose name, up to '#', is in
    `names`."""
    return [(a, b) for n, a, b, tid in trace.host
            if tid == trace.tid and n.partition("#")[0] in names]


def launched_ms(trace, found: list, any_thread: bool = False) -> float | None:
    """Device ms of the operations whose launch (the runtime call of the same
    correlation id) started inside one of the spans `found`: on the window's thread, or
    with `any_thread` on any thread, as autograd's backward launches from a thread of its
    own while the window's thread waits in `.backward()`. None where `found` is empty."""
    if not found:
        return None
    merged = union(found)
    starts = [a for a, _ in merged]
    total = 0.0
    for _, a, b, corr in trace.device:
        at = trace.launch.get(corr)
        if at is None or (not any_thread and at[1] != trace.tid):
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and at[0] <= merged[i][1]:
            total += b - a
    return total / 1e3


def idle_ms(trace, found: list) -> float | None:
    """ms inside the spans `found` (their union, within the slice) in which no operation
    ran on the device. None where `found` is empty."""
    if not found:
        return None
    idle = gaps([(a, b) for _, a, b, _ in trace.device], trace.lo, trace.hi)
    total, j = 0.0, 0
    for a, b in union(found):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            total += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    return total / 1e3


def per_unit(run, ms):
    return None if ms is None else ms / len(run.sliced)


def stages_before_last(trace) -> set:
    """`tts.gen.pre` and the generator's stage spans but the last stage's (the highest
    index met in the slice)."""
    index = {n: int(m.group(1)) for n, *_ in trace.host
             if (m := STAGE.match(n.partition("#")[0]))}
    if not index:
        return set()
    last = max(index.values())
    return {"tts.gen.pre"} | {n for n, i in index.items() if i < last}


BACKWARD = ("tts.train.d_backward", "tts.train.gt_backward")
