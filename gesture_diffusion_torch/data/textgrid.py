"""Minimal Praat TextGrid reader (long format).

A copy of ``gesture_diffusion_tpu/data/textgrid.py`` (the standard library
only), kept here so the port never imports the JAX package:
``read_textgrid(path)[0]`` -> list of (min_time, max_time, mark), the word
intervals of tier 0 that BEAT preprocessing reads.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple


class Interval(NamedTuple):
    min_time: float
    max_time: float
    mark: str


def read_textgrid(path: str) -> List[List[Interval]]:
    # Praat saves UTF-16 with a BOM whenever any mark is non-ASCII (the
    # reference's textgrid package BOM-sniffed too); decoding those as
    # utf-8 would NUL-interleave the text and parse to zero tiers.
    # UTF-32 BOMs are sniffed first (UTF-32-LE starts ff fe 00 00 — a
    # 2-byte check would misread it as UTF-16-LE), and every decode keeps
    # errors="replace": a truncated/corrupt file degrades instead of
    # killing a whole prep run.
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] in (b"\xff\xfe\x00\x00", b"\x00\x00\xfe\xff"):
        text = raw.decode("utf-32", errors="replace")
    elif raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        text = raw.decode("utf-16", errors="replace")
    else:
        text = raw.decode("utf-8-sig", errors="replace")
    tiers: List[List[Interval]] = []
    # split on tier items; the long format marks each tier with 'item [n]:'
    tier_chunks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for chunk in tier_chunks:
        intervals = []
        for m in re.finditer(
            r"intervals\s*\[\d+\]\s*:\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"((?:[^"]|"")*)"',
            chunk,
        ):
            intervals.append(Interval(
                float(m.group(1)), float(m.group(2)),
                m.group(3).replace('""', '"')))
        tiers.append(intervals)
    return tiers
