"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (the ``file`` its entry gives), a traffic mix
(``traffic/<name>.json``) and per-layer metrics (``metrics/<name>.py``, each
with ``read(run) -> number or None``). A later cell adds files and entries;
nothing here names a cell.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import check, roofline, trace, traffic_gen
from port_bench.capture import COUNT_SPAN, SPANS, Hooks, Plan

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sycl_points_tpu")
TRACE_SLICE_S = 3.0  # the traced run profiles the window's last seconds (5 frames at least)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(roots, sub: str, name: str, ext: str) -> str:
    """``<root>/<sub>/<name><ext>`` under the first root that has it."""
    for root in roots:
        path = os.path.join(root, sub, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {sub}/{name}{ext} under {list(roots)}")


def resolve(bench: dict, workload: str, roots=(HERE,), base: str = REPO) -> SimpleNamespace:
    """The cell's entry, configuration, traffic and metric readers."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark ({sorted(cells)})")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(base, cfg_entry["file"]))
    traffic = traffic_gen.load(find(roots, "traffic", cell["traffic"], ".json"))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, end_to_end=e2e, per_layer=layer, roots=roots)


def _load_reader(roots, name: str):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", find(roots, "metrics", name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _import(path: str):
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def forbidden_modules() -> list:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_fleet(spec, replay, seed: int, devices):
    from sycl_points_tpu_torch.pipeline.params import load_params

    params = load_params(spec.config["params"], cls=_import(spec.config["params_class"]))
    entry = _import(spec.config["entry"])
    T0 = replay.start_poses()
    kw = {"device": devices[0], **({"mesh": devices} if len(devices) > 1 else {})}
    return entry(params, n_streams=replay.streams, initial_poses=T0, seed=seed % (1 << 31), **kw)


class Driver:
    """Calls the fleet frame after frame, closed loop: the IMU readings up
    to the frame, ``process_batch``, then which frames have resolved."""

    def __init__(self, fleet, replay, traffic, hooks):
        self.fleet, self.replay, self.tp, self.hooks = fleet, replay, traffic, hooks
        self.frame = 0
        self.called = {}  # frame -> host time of its call
        self.resolved = {}  # frame -> host time it was seen resolved
        self._seen = 0
        self.inertial = hasattr(fleet, "add_imu_measurement") and replay.imu_hz > 0
        if self.inertial:
            from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement
            self._imu = IMUMeasurement
            self.gyro, self.accel = traffic_gen.imu_table(traffic)

    def feed(self, f: int) -> None:
        """Each stream's readings from the last frame to this one, at its
        place of the loop."""
        times = traffic_gen.imu_times(self.tp, f)
        K = len(times)
        add, M, L = self.fleet.add_imu_measurement, self._imu, self.replay.loop_frames
        for s, p in enumerate(self.replay.phases):
            j = (f + int(p)) % L
            g, a = self.gyro[j, -K:], self.accel[j, -K:]
            for k in range(K):
                add(s, M(timestamp=float(times[k]), gyro=g[k], accel=a[k]))

    def step(self) -> float:
        from sycl_points_tpu_torch.points.point_cloud import PointCloud

        f = self.frame
        self.hooks.frame = f
        with self.hooks.span("bench.feed"):
            if self.inertial:
                self.feed(f)
            points, mask = self.replay.frame(f)
            cloud = PointCloud(points=points, mask=mask)
        t0 = time.perf_counter()
        with self.hooks.span("bench.call"):
            self.fleet.process_batch(cloud, self.replay.time(f))
        now = time.perf_counter()
        self.called[f] = t0
        self.note(now)
        self.frame += 1
        return now

    def note(self, now: float) -> None:
        log = self.fleet.pose_log[0]
        for entry in log[self._seen:]:
            self.resolved[entry[0]] = now
        self._seen = len(log)


def window_stats(called: dict, resolved: dict, successes: int, t0: float, t_end: float) -> dict:
    """The window's end-to-end numbers: every success over all the window,
    and the tail over every frame called in it."""
    ms = [(resolved[f] - called[f]) * 1e3 for f in sorted(called) if f in resolved]
    return {"window_s": t_end - t0, "frames": len(called), "stream_frames_per_s": successes / (t_end - t0),
            "frame_ms_p95": float(np.percentile(ms, 95)) if ms else None,
            "frame_ms_p50": statistics.median(ms) if ms else None}


def _count_results(fleet, frames: set) -> tuple:
    """``(successes, not successes)`` of the resolved stream-frames of ``frames``."""
    ok = bad = 0
    for log in fleet.deferred_results:
        for f, rtype in log:
            if f in frames:
                if rtype.value == "success":
                    ok += 1
                else:
                    bad += 1
    return ok, bad


def run_cell(spec, seed: int, seconds: float, traced: bool, devices, t_start: float,
             control: bool = False) -> dict:
    from sycl_points_tpu_torch.ops import cuda_knn
    from sycl_points_tpu_torch.utils import sync

    tp, cfg = spec.traffic, spec.config
    dev0 = devices[0]
    if dev0.type == "cuda":
        cuda_knn.load_library()  # the kernels' build, once a checkout
        for d in devices:
            torch.empty(1, device=d)  # the device's context, before its statistics
            torch.cuda.reset_peak_memory_stats(d)
    marks = {"start": time.perf_counter() - t_start}
    replay = traffic_gen.make_replay(tp, seed, devices)
    _sync(devices)
    marks["replay"] = time.perf_counter() - t_start
    fleet = make_fleet(spec, replay, seed, devices)
    marks["fleet"] = time.perf_counter() - t_start
    plan_cfg = cfg["check"]["plan"]
    plan = Plan(seed, replay.streams, replay.warmup, plan_cfg["every"], plan_cfg["streams"], plan_cfg["frames"])
    hooks = Hooks(fleet, plan, replay).install()
    drv = Driver(fleet, replay, tp, hooks)
    try:
        for _ in range(replay.warmup):
            drv.step()
        fleet.flush()
        _sync(devices)
        setup_s = time.perf_counter() - t_start
        marks["warmup"] = setup_s

        # ---- the window ----------------------------------------------------------
        reads0 = sync.counts["host_syncs"]
        slice_s = TRACE_SLICE_S if traced else 0.0
        t0 = time.perf_counter()
        now = t0
        while now - t0 < seconds - slice_s:
            now = drv.step()
        untraced_end = now
        n_untraced = drv.frame
        tr = {}
        if traced:
            hooks.tracing = hooks.counting = True
            prof = trace.profiler()
            prof.start()
            t_slice = time.perf_counter()
            with torch.profiler.record_function(trace.SLICE):
                f_slice0 = drv.frame
                while now - t_slice < slice_s or drv.frame - f_slice0 < 5:
                    now = drv.step()
                _sync(devices)
            prof.stop()
            hooks.tracing = False
            launches = hooks.end_counting()
            tr = trace.analyze(prof, COUNT_SPAN, SPANS, len(devices))
            tr["frames"] = drv.frame - f_slice0
            tr["least_s"] = roofline.least_seconds(launches)
            del prof
        t_end = now
        window = set(range(replay.warmup, drv.frame))
        successes, _ = _count_results(fleet, window)
        reads = sync.counts["host_syncs"] - reads0
        fleet.flush()
        _sync(devices)
        drv.note(time.perf_counter())
        _, bad = _count_results(fleet, window)
        stats = window_stats({f: t for f, t in drv.called.items() if f in window and f < n_untraced},
                             drv.resolved, successes, t0, t_end)
        iters = _loop_iterations(fleet, window)
        peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)
        poses = {(c["frame"], c["stream"]): None for k in ("reg", "lio") for c in hooks.captures[k]}
        for (f, s) in poses:
            poses[(f, s)] = next(((T, r) for i, _, T, r in fleet.pose_log[s] if i == f), None)
    finally:
        hooks.uninstall()
    captures = hooks.captures
    del fleet, hooks, drv, replay
    gc.collect()
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

    checks = check.run(captures, poses, cfg, failed=bad)
    if control:
        ctrl = check.run(*check.control_captures(captures, cfg, seed), cfg)
    run = SimpleNamespace(frames=len(window), host_reads=reads, loop_iterations=iters, window=stats, trace=tr)
    metrics = {}
    if traced:
        for m in spec.per_layer:
            value = _load_reader(spec.roots, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **{k: v for k, v in stats.items() if v is not None}}
        for m in spec.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
              "kind": torch.cuda.get_device_name(dev0) if dev0.type == "cuda" else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": checks["correct"], "attempted": len(window) * tp["streams"], "failed": bad,
           "metrics": metrics, "device": device}
    if traced and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["detail"] = {"setup_s": setup_s, "setup_marks": marks, "window": stats, "host_reads": reads,
                     "checked": checks["counts"],
                     "trace": {k: v for k, v in tr.items() if k not in ("device_ops", "idle_gaps")}}
    if control:
        out["control"] = {"correct": ctrl["correct"], "numbers": ctrl["numbers"], "counts": ctrl["counts"]}
    out["checks"] = checks["numbers"]  # last: each number compared, with its limit
    return out


def _loop_iterations(fleet, frames: set) -> list:
    """The align loop's iterations of each frame of ``frames``: its slowest
    stream's."""
    most = {}
    for log, its in zip(fleet.pose_log, fleet.align_iterations):
        for (f, *_), n in zip(log, its):
            if f in frames:
                most[f] = max(most.get(f, 0), n)
    return [most[f] for f in sorted(most)]
