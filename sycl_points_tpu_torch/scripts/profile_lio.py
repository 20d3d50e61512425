"""Where the LiDAR-inertial frame spends the card: ``torch.profiler`` over
the full-width LIO replay (``apps.lio_replay`` defaults, 2048 x 64 rays).

    python -m sycl_points_tpu_torch.scripts.profile_lio [--frames 12]

Runs the replay once to warm up, then profiles a second run of the same
frames and prints, over the frames after the first (each inside the
replay's ``replay.frame`` span on the host): the wall time a frame with and
without the profiler, the CUDA kernels launched and the device-busy time
(the union of kernel and copy intervals) a frame under the profiler, the
top-level ops called most, and the top-level ops a frame of each part of
the frame (each part a function of the package that the script wraps in a
profiler span for its run, where its caller looks it up; the script fails
if a part is never entered, so a moved call site cannot pass its ops to
"other"). The profiler stretches the frame, so the device's idle share
is not read from this trace. Prints "not measured" where the trace holds
no device events.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import importlib

import torch
from torch.profiler import ProfilerActivity, profile

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps import lio_replay, odometry_replay

_DEVICE = torch.autograd.DeviceType.CUDA
# (module, attribute) of the parts whose ops are counted; each is looked up
# where its caller finds it
PARTS = (
    ("sycl_points_tpu_torch.pipeline.pc_processor", "PCProcessor.prefilter"),
    ("sycl_points_tpu_torch.pipeline.pc_processor", "PCProcessor.prepare_context"),
    ("sycl_points_tpu_torch.pipeline.pc_processor", "PCProcessor.compute_covariances"),
    ("sycl_points_tpu_torch.pipeline.pc_processor", "PCProcessor.refine_filter"),
    ("sycl_points_tpu_torch.pipeline.lidar_inertial_odometry", "integrate_steps"),
    ("sycl_points_tpu_torch.registration.registration", "_precompute_targets"),
    ("sycl_points_tpu_torch.registration.registration", "_correspondences"),
    ("sycl_points_tpu_torch.registration.registration", "_linearize"),
    ("sycl_points_tpu_torch.lio.lio_registration", "compute_imu_hessian_gradient"),
    ("sycl_points_tpu_torch.lio.lio_registration", "compute_imu_gradient"),
    ("sycl_points_tpu_torch.lio.lio_registration", "add_icp_factor"),
    ("sycl_points_tpu_torch.lio.lio_registration", "apply_directional_icp_weighting"),
    ("sycl_points_tpu_torch.lio.lio_registration", "solve_psd"),
    ("sycl_points_tpu_torch.lio.lio_registration", "retract"),
    ("sycl_points_tpu_torch.lio.lio_registration", "select"),
)


@contextlib.contextmanager
def _part_spans():
    """Wrap every part in a profiler span named after it, for the block."""
    saved = []
    for mod_name, attr in PARTS:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def spanned(*a, _fn=fn, _name=attr, **k):
            with torch.profiler.record_function("part:" + _name):
                return _fn(*a, **k)

        saved.append((owner, name, fn))
        setattr(owner, name, spanned)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main(argv=None, device: torch.device | str = "cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args(argv)
    dev = require_device(device)
    inputs = lio_replay.make_lio_inputs(args.frames, device=dev)
    params = lio_replay.lio_params(inputs.poses[0])
    warm = lio_replay.run_lio_replay(params, inputs, device=dev)
    with _part_spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = lio_replay.run_lio_replay(params, inputs, device=dev)
    events = prof.events()
    host = [e for e in events if e.device_type != _DEVICE]
    # the host spans of the frames after the first (the trace also mirrors
    # each span on the device's timeline)
    spans = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == odometry_replay.FRAME_SPAN)[1:]

    def in_frames(e):
        return any(a <= e.time_range.start <= b for a, b in spans)

    device_events = [e for e in events if e.device_type == _DEVICE and e.name != odometry_replay.FRAME_SPAN
                     and in_frames(e)]
    kernels = [e for e in device_events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    top = [e for e in host if e.name.startswith("aten::") and in_frames(e)
           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    calls = collections.Counter(e.name for e in top)
    by_part = collections.Counter()
    for e in top:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("part:"):
            p = p.cpu_parent
        by_part[p.name[5:] if p is not None else "other"] += 1
    entered = collections.Counter(e.name[5:] for e in host if e.name.startswith("part:") and in_frames(e)
                                  and (e.cpu_parent is None or not e.cpu_parent.name.startswith("part:")))
    missing = sorted({attr for _, attr in PARTS} - {e.name[5:] for e in host if e.name.startswith("part:")})
    if missing:
        raise RuntimeError(f"parts never entered in the profiled frames (moved call sites?): {missing}")
    n = len(spans)
    wall_ms = sum(b - a for a, b in spans) / 1e3
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in device_events) / 1e3
    rows = out["rows"][1:]
    print(f"{torch.cuda.get_device_name(dev)}: {n} LIO frames after the first, "
          f"{sum(r['iterations'] for r in rows)} iterations, wall {wall_ms / n:.3f} ms a frame under the profiler "
          f"({sum(r['ms'] for r in warm['rows'][1:]) / n:.3f} ms in the warm-up run, no profiler)")
    if device_events:
        print(f"kernels {len(kernels) / n:.1f} a frame, copies and sets {(len(device_events) - len(kernels)) / n:.1f} "
              f"a frame, device busy {busy_ms / n:.3f} ms a frame under the profiler")
    else:
        print("kernels and device busy time: not measured (no device events in the trace)")
    print(f"top-level aten calls a frame: {sum(calls.values()) / n:.1f}; most called: "
          + ", ".join(f"{name} {c / n:.1f}" for name, c in calls.most_common(10)))
    print("top-level aten calls a frame by part (calls a frame x calls each): " + ", ".join(
        f"{part} {c / n:.1f}" + (f" ({entered[part] / n:.2f} x {c / max(entered[part], 1):.1f})"
                                 if part in entered else "")
        for part, c in by_part.most_common()))
    return {"frames": n, "wall_ms": wall_ms, "kernels": len(kernels), "busy_ms": busy_ms}


if __name__ == "__main__":
    main()
