"""Reading a ``torch.profiler`` trace of the traced window.

The trace (``Trace``) is first reduced to plain records ``(name, kind, start_us,
end_us)`` with kind ``"device"`` (a kernel, copy or fill on the card),
``"runtime"`` (a CUDA runtime or driver call that puts work on the card:
a launch, a copy, a fill or a graph launch) or ``"cpu"`` (any other host
operation), so that the arithmetic below runs as well on a synthetic
trace.  The window is the span of the benchmark's own ``bench.pass``
spans.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PASS_SPAN = "bench.pass"
#: The host calls that issue work to the card, by the runtime's and the
#: driver's names.
RUNTIME_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemcpyPeerAsync",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoDAsync_v2",
    "cudaMemset", "cudaMemsetAsync", "cuMemsetD8Async", "cuMemsetD32Async",
    "cudaGraphLaunch", "cuGraphLaunch",
})
#: Gaps are named by the innermost host operation over their middle; this
#: many of the longest are named.
NAMED_GAPS = 400000


class Trace:
    """A profiler over CPU and CUDA activity, read from its raw results
    (the per-event Python objects of ``torch.profiler`` take minutes to
    build for a render pass's quarter of a million events).  Use as a
    context manager; ``records()`` then gives the trace."""

    def __enter__(self):
        import torch
        from torch.autograd.profiler import (ProfilerActivity, _enable_profiler,
                                             _prepare_profiler)

        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        cfg = torch.autograd.profiler.profile(use_device="cuda", use_kineto=True).config()
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        return self

    def __exit__(self, *exc):
        from torch.autograd.profiler import _disable_profiler

        self._result = _disable_profiler()
        return False

    def records(self) -> list:
        """The events as ``(name, kind, start_us, end_us)``; the device
        side of the benchmark's own spans is left out."""
        from torch.autograd import DeviceType

        out = []
        for e in self._result.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name == PASS_SPAN:
                    continue
                kind = "device"
            else:
                kind = "runtime" if name in RUNTIME_CALLS else "cpu"
            out.append((name, kind, e.start_ns() * 1e-3, e.end_ns() * 1e-3))
        return out


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(cpu, starts, t):
    """The name of the host operation with the latest start that covers
    ``t``, or ``"host: no operation"``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        name, _, s, e = cpu[j]
        if s <= t <= e and name != PASS_SPAN:
            return name
    return "host: no operation"


def summarize(records: list, top: int = 10) -> dict:
    """The traced window's numbers: ``window_s`` (first ``bench.pass``
    start to last end), ``passes``, ``busy_s`` (the union of device
    intervals inside the window), ``runtime_calls`` (work-issuing host calls
    inside the window), ``kernel_s`` (device seconds by name), and the
    ``breakdown``: the ``top`` device operations by time and the idle gaps
    summed by what the host was doing."""
    spans = [r for r in records if r[0] == PASS_SPAN]
    if not spans:
        raise ValueError(f"the trace has no {PASS_SPAN} span")
    w0, w1 = min(r[2] for r in spans), max(r[3] for r in spans)
    inside = lambda r: r[2] >= w0 and r[3] <= w1
    dev = [r for r in records if r[1] == "device" and r[3] > w0 and r[2] < w1]
    merged = _union((max(r[2], w0), min(r[3], w1)) for r in dev)
    busy = sum(e - s for s, e in merged)
    kernel = defaultdict(float)
    for r in dev:
        kernel[r[0]] += (r[3] - r[2]) * 1e-6
    runtime = sum(1 for r in records if r[1] == "runtime" and inside(r))
    # Host calls into CUDA by name, to show what ``runtime_calls`` counts.
    cu = defaultdict(int)
    for r in records:
        if r[1] != "device" and r[0].startswith("cu") and inside(r):
            cu[r[0]] += 1

    gaps = [(s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    if merged:
        gaps += [(merged[0][0] - w0, w0, merged[0][0]), (w1 - merged[-1][1], merged[-1][1], w1)]
    else:
        gaps.append((w1 - w0, w0, w1))
    gaps.sort(reverse=True)
    cpu = sorted((r for r in records if r[1] != "device"), key=lambda r: r[2])
    starts = [r[2] for r in cpu]
    by_host = defaultdict(float)
    for length, s, e in gaps[:NAMED_GAPS]:
        if length > 0:
            by_host[_innermost(cpu, starts, 0.5 * (s + e))] += length * 1e-6
    rest = sum(g[0] for g in gaps[NAMED_GAPS:] if g[0] > 0) * 1e-6
    if rest:
        by_host["shorter gaps"] += rest
    rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (w1 - w0) * 1e-6, "passes": len(spans), "busy_s": busy * 1e-6,
            "runtime_calls": runtime, "device_events": len(dev), "cuda_calls": dict(cu),
            "kernel_s": dict(kernel),
            "breakdown": {"device_ops": rank(kernel), "idle_gaps": rank(by_host)}}


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name contains ``fragment``."""
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)
