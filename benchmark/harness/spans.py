"""The card's idle time inside the program's stage spans.

The program marks its stages with ``rt3.*`` spans on the profiler's clock
(``raytrace3_tpu_torch/utils/trace.py``).  From the same records
``profile.summarize`` reads, ``(name, kind, start_us, end_us)``, the card's
idle intervals are the complement of the union of device intervals inside
the traced window (first ``bench.pass`` start to last end); each span
name's idle seconds are the length of their intersection with the union of
that name's host intervals, by a sweep over the two sorted lists.  A trace
without such spans (a program that has none) gives an empty dict.
"""

from __future__ import annotations

from collections import defaultdict

from .profile import PASS_SPAN, _union

#: The program's span names begin with this.
PREFIX = "rt3."


def _overlap(a: list, b: list) -> float:
    """Total length of the intersection of two sorted lists of disjoint
    [start, end) intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans(records: list) -> dict:
    """{span name: seconds the card was idle inside that name's spans}
    within the traced window, for every ``rt3.*`` name in ``records``."""
    passes = [r for r in records if r[0] == PASS_SPAN]
    if not passes:
        return {}
    w0, w1 = min(r[2] for r in passes), max(r[3] for r in passes)
    clip = lambda rs: _union((max(r[2], w0), min(r[3], w1)) for r in rs
                             if r[3] > w0 and r[2] < w1)
    busy = clip(r for r in records if r[1] == "device")
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    by_name = defaultdict(list)
    for r in records:
        if r[1] != "device" and r[0].startswith(PREFIX):
            by_name[r[0]].append(r)
    return {name: _overlap(idle, clip(rs)) * 1e-6 for name, rs in sorted(by_name.items())}
