"""The program's own spans (``fspt.*``, ``fspt_tpu_torch/utils/profiling.span``)
in the traced window: host milliseconds inside them, and device-idle
milliseconds under them, an iteration.

A span's intervals are the host events of its name that the profiler
recorded (``Reading._cpu``: name, start and end in µs on the profiler's
clock, the device records' clock).  The program records them only while a
profiler records, so every one falls inside the traced iterations; a
reading divides by ``Reading.iterations``.
"""

from __future__ import annotations


def intervals(reading, name: str) -> list:
    """The union of the host intervals of the span ``name``, sorted and
    disjoint, as ``[(start_us, end_us)]``."""
    merged = []
    for s, f in sorted((s, f) for n, s, f in reading._cpu if n == name):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], f))
        else:
            merged.append((s, f))
    return merged


def overlap_us(a: list, b: list) -> float:
    """µs in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(reading, name: str):
    """Host ms an iteration inside the span ``name``, or None where the
    window holds no such span."""
    spans = intervals(reading, name)
    if not spans:
        return None
    return sum(f - s for s, f in spans) * 1e-3 / reading.iterations


def idle_ms(reading, name: str):
    """Device-idle ms an iteration that overlaps the span ``name`` (the
    window's gaps, where nothing ran on the device, intersected with the
    span's intervals), or None where the window holds no such span."""
    spans = intervals(reading, name)
    if not spans:
        return None
    return overlap_us(reading.gaps, spans) * 1e-3 / reading.iterations
