"""The window's arithmetic: the rate over all successes and all the time,
the tail over every frame."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import trace
from port_bench.harness import window_stats


def test_rate_is_every_success_over_the_whole_window():
    called = {f: 10.0 + 0.1 * f for f in range(100)}
    resolved = {f: t + 0.25 for f, t in called.items()}
    out = window_stats(called, resolved, successes=2560, t0=10.0, t_end=20.0)
    assert out["stream_frames_per_s"] == pytest.approx(256.0)
    assert out["frames"] == 100


def test_tail_is_over_all_frames_not_chunk_medians():
    called = {f: float(f) for f in range(200)}
    # one slow frame in ten: chunk medians of ten would never see them
    resolved = {f: f + (0.5 if f % 10 == 0 else 0.1) for f in range(200)}
    out = window_stats(called, resolved, successes=1, t0=0.0, t_end=200.0)
    ms = [(resolved[f] - called[f]) * 1e3 for f in range(200)]
    assert out["frame_ms_p95"] == pytest.approx(np.percentile(ms, 95))
    assert out["frame_ms_p95"] > 400.0
    assert out["frame_ms_p50"] == pytest.approx(100.0)


def test_frames_never_resolved_do_not_count_as_fast():
    called = {0: 0.0, 1: 1.0}
    out = window_stats(called, {0: 0.5}, successes=1, t0=0.0, t_end=2.0)
    assert out["frame_ms_p95"] == pytest.approx(500.0)


def test_union_of_intervals():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_s([]) == 0
