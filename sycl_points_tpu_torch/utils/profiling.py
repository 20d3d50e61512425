"""Profiler capture (counterpart of :mod:`sycl_points_tpu.utils.profiling`).

:func:`trace` records the host ops and, where a card is present, its kernels
with ``torch.profiler`` over the enclosed block and writes a Chrome trace
(``trace.json``, for Perfetto or ``chrome://tracing``) into ``log_dir``;
:func:`annotate` names a span inside it.
"""

from __future__ import annotations

import contextlib
import os

import torch

# Device cycles of idle work (~10 ms at 2 GHz) queued when a trace starts.
# The profiler keeps only device records time-stamped inside its capture
# window, opened on the host's clock; the card's clock drifts from it over a
# long process, and the first kernels of a block fell outside the window.
_LEAD_CYCLES = 20_000_000


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into ``log_dir/trace.json``::

        with profiling.trace("traces"):
            odometry.process(scan, t)

    Yields the ``torch.profiler.profile`` object (its ``key_averages()``
    sums the time by op and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        if torch.cuda.is_available():
            torch.cuda._sleep(_LEAD_CYCLES)  # the block's kernels start well inside the window
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
