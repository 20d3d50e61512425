"""The traced slice: the profiler's events reduced to device time.

The slice runs under ``torch.profiler`` (CPU and CUDA activities, events
kept in memory, nothing exported) inside a span named :data:`SLICE`. From
the raw events:

- ``busy_s``: the union of each device's kernel, copy and set intervals
  inside the slice (a copy of ``scripts/profile_lio.py:_union_us``),
  averaged over the devices, beside the slice's length ``window_s``;
- each kernel's device time by name, the launches, and the time of the
  kernel classes whose roofline the benchmark reads;
- the idle gaps between busy intervals, each put down to the innermost span
  the host was in at its middle (the benchmark's spans around the layers).

Kernels launched inside the benchmark's own counting span
(:data:`port_bench.capture.COUNT_SPAN`) are left out of all of it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

SLICE = "port_bench.slice"
KERNEL_CLASSES = {
    "nn1": re.compile(r"knn_cluster_kernel(<1,|ILi1E)"),
    "knn_k": re.compile(r"knn_cluster_kernel(<([2-9]|\d\d+),|ILi([2-9]|\d\d+)E)|knn_warp_kernel"),
}


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _times(e) -> tuple:
    """``(start, end)`` of a raw event, in ns (older builds give us)."""
    if hasattr(e, "start_ns"):
        a = e.start_ns()
        return a, a + (e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000))
    a = int(e.start_us() * 1000)
    return a, a + int(e.duration_us() * 1000)


def _on_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def analyze(prof, count_span: str, spans=(), n_devices: int = 1) -> dict:
    """The slice's device numbers from the profiler's raw events; ``spans``
    are the benchmark's span names, which the trace also mirrors on the
    device's timeline; ``n_devices`` the devices the run uses."""
    evs = prof.profiler.kineto_results.events()
    names = {SLICE, count_span, *spans}
    host, runtime, device = [], [], []
    for e in evs:
        name = e.name()
        if _on_device(e):
            if name not in names:
                device.append(e)
        elif name in names:
            host.append(e)
        elif name.startswith("cuda"):
            runtime.append(e)
    slices = [e for e in host if e.name() == SLICE]
    if not slices:
        return {}
    s0, s1 = _times(slices[0])
    counting = sorted((*_times(e), e.start_thread_id()) for e in host if e.name() == count_span)
    starts = [c[0] for c in counting]

    def in_count(r) -> bool:
        t = _times(r)[0]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and counting[i][1] >= t and counting[i][2] == r.start_thread_id()

    excluded = {r.correlation_id() for r in runtime if in_count(r)}

    busy, by_name, classes = defaultdict(list), defaultdict(float), defaultdict(float)
    launches = n_excluded = 0
    for e in device:
        if e.correlation_id() in excluded or e.linked_correlation_id() in excluded:
            n_excluded += 1
            continue
        a, b = _times(e)
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        busy[e.device_index()].append((a, b))
        name = e.name()
        by_name[name[:160]] += (b - a) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
            for cls, pat in KERNEL_CLASSES.items():
                if pat.search(name):
                    classes[cls] += (b - a) * 1e-9

    gaps = defaultdict(float)
    merged = []
    for a, b in sorted(iv for ivs in busy.values() for iv in ivs):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [s0] + [x for ab in merged for x in ab] + [s1]
    spans = sorted((*_times(e), e.name()) for e in host if e.name() not in (SLICE, count_span))
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [(st, name) for st, en, name in spans if st <= mid <= en]
        gaps[max(inner)[1] if inner else "host outside the layers"] += (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # busy: the union of each device's intervals, averaged over the devices
    # the run uses (gaps: the time no device ran anything)
    busy_s = sum(union_s(ivs) for ivs in busy.values()) / max(n_devices, 1) * 1e-9
    return {"window_s": (s1 - s0) * 1e-9, "busy_s": busy_s, "devices": len(busy), "launches": launches,
            "class_s": dict(classes), "excluded": n_excluded,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
