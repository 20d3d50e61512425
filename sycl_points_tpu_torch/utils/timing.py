"""Per-stage timing (counterpart of :mod:`sycl_points_tpu.utils.timing`).

:func:`measure_execution` is the reference's stopwatch: it times a call and,
when the result holds tensors on the card, includes their device work by
synchronizing each card they lie on. :class:`StageTimer` keeps the
reference pipelines' table of average microseconds per stage.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (tensors, and tuples,
    lists, dicts and dataclasses of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _cuda_devices(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


def measure_execution(func: Callable, block: bool = True):
    """Run ``func`` and return ``(result, elapsed_us)``; with ``block`` the
    time includes the device work of the result's tensors on the card."""
    t0 = time.perf_counter()
    result = func()
    if block:
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
    return result, (time.perf_counter() - t0) * 1e6


class StageTimer:
    """Accumulating wall-clock table of the stages of a pipeline (the
    '1. preprocessing' ... '4. build submap' map of the reference's
    pipelines)."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    def measure(self, name: str, func: Callable):
        result, us = measure_execution(func)
        self.total[name] += us
        self.count[name] += 1
        return result

    def add(self, name: str, seconds: float) -> None:
        self.total[name] += seconds * 1e6
        self.count[name] += 1

    def averages_us(self) -> Dict[str, float]:
        return {k: self.total[k] / max(self.count[k], 1) for k in sorted(self.total)}

    def report(self) -> str:
        lines = []
        total = 0.0
        for name, avg in self.averages_us().items():
            lines.append(f"{name + ':':>28s} {avg:9.2f} us")
            total += avg
        lines.append(f"{'TOTAL:':>28s} {total:9.2f} us")
        return "\n".join(lines)
