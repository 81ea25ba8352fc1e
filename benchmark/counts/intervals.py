"""Interval arithmetic over a device trace: the union of busy intervals (concurrent
operations counted once) and the idle gaps inside a window."""

from __future__ import annotations


def union(intervals) -> list:
    """Sorted, merged [start, end) pairs covering the given ones."""
    out = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) pairs of [lo, hi) outside every interval."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
