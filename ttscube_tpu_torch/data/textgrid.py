"""Minimal Praat TextGrid parser (long text format, as written by the Montreal Forced
Aligner): the port's copy of `ttscube_tpu/data/textgrid.py`.

Returns tiers as lists of {"text", "start", "stop"} interval dicts.
"""

from __future__ import annotations

import re


def parse_textgrid(path: str) -> list[list[dict]]:
    text = open(path, encoding="utf-8", errors="replace").read()
    tiers: list[list[dict]] = []
    # split on tier headers: item [N]:
    chunks = re.split(r"item\s*\[\d+\]\s*:", text)
    for chunk in chunks[1:]:
        if '"IntervalTier"' not in chunk:
            continue
        intervals = []
        for m in re.finditer(
                r"intervals\s*\[\d+\]\s*:\s*"
                r"xmin\s*=\s*([\d.eE+-]+)\s*"
                r"xmax\s*=\s*([\d.eE+-]+)\s*"
                r'text\s*=\s*"((?:[^"]|"")*)"', chunk):
            intervals.append({
                "text": m.group(3).replace('""', '"'),
                "start": float(m.group(1)),
                "stop": float(m.group(2)),
            })
        tiers.append(intervals)
    return tiers


def write_textgrid(path: str, tiers: list[tuple[str, list[dict]]], xmax: float):
    """Inverse (used by tests and lab-file tooling)."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {xmax}", "tiers? <exists>",
             f"size = {len(tiers)}", "item []:"]
    for ti, (name, intervals) in enumerate(tiers, 1):
        lines += [f"    item [{ti}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0",
                  f"        xmax = {xmax}",
                  f"        intervals: size = {len(intervals)}"]
        for ii, iv in enumerate(intervals, 1):
            lines += [f"        intervals [{ii}]:",
                      f"            xmin = {iv['start']}",
                      f"            xmax = {iv['stop']}",
                      '            text = "{}"'.format(iv["text"].replace('"', '""'))]
    open(path, "w", encoding="utf-8").write("\n".join(lines) + "\n")
