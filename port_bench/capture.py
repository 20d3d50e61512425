"""What the benchmark wraps around the program's layers.

:class:`Hooks` replaces, for one run, the entry of each layer it reads with
a wrapper that calls the original and then

- copies, at the frames and streams that :class:`Plan` draws from the seed,
  what the stage took and gave (device copies, no host read): the
  preprocessed scan, the registration's inputs, the submap step's inputs and
  outputs; the reference judges them once the window has closed;
- in the traced slice, counts the work of each batched k-NN launch (the
  valid rows of its target, once a prepared target) for the kernels'
  roofline shares, and marks each layer with a profiler span.

Only the benchmark's own wrappers are added: the program is not edited.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

import numpy as np
import torch

from port_bench import traffic_gen

COUNT_SPAN = "port_bench.count"
# the spans the benchmark puts around the layers (and around its own work)
SPANS = ("fleet.preprocess", "registration.align", "submap.step", "fleet.resolve", "bench.feed", "bench.call")


class Plan:
    """Which frames and streams a run captures: every ``every``-th window
    frame from a seeded phase, ``per_frame`` streams of it; the submap step
    is read on the first keyframe stream of a seeded order."""

    def __init__(self, seed: int, streams: int, first: int, every: int, per_frame: int, max_frames: int):
        self.seed, self.B, self.first, self.every, self.per_frame = seed, streams, first, every, per_frame
        self.last = first + every * max_frames
        self.phase = int(np.random.default_rng(traffic_gen.seed_words(seed, 7)).integers(every))

    def captured(self, frame: int) -> bool:
        return self.first <= frame < self.last and (frame - self.first) % self.every == self.phase

    def order(self, frame: int) -> np.ndarray:
        """Every stream, in the frame's seeded order; the first
        ``per_frame`` are the captured ones."""
        return np.random.default_rng(traffic_gen.seed_words(self.seed, 11, frame)).permutation(self.B)

    def streams(self, frame: int) -> List[int]:
        return [int(s) for s in self.order(frame)[: self.per_frame]] if self.captured(frame) else []


def _rows(cloud, b: int, fields=("points", "mask", "covs")) -> dict:
    return {f: getattr(cloud, f)[b].clone() for f in fields if getattr(cloud, f, None) is not None}


def _fleets(fleet) -> list:
    """``(rank, unsharded fleet)`` of each shard (the fleet itself unsharded)."""
    return list(enumerate(getattr(fleet, "_shards", [fleet])))


class Hooks:
    def __init__(self, fleet, plan: Plan, replay):
        self.fleet, self.plan, self.replay = fleet, plan, replay
        self.frame = -1
        self.tracing = False
        self.counting = False
        self.captures: Dict[str, list] = {"pre": [], "reg": [], "lio": [], "map": [], "raw": []}
        self.launches: list = []  # (kind, key, Q, k, B) of each counted k-NN launch
        self.valid_rows: dict = {}  # key -> (target tensor, [B] valid rows)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._undo: list = []
        self._shard_b = fleet.B // len(_fleets(fleet))

    # ---- the wrappers -----------------------------------------------------------
    def span(self, name: str):
        return torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()

    def _set(self, obj, name: str, value) -> None:
        had = name in vars(obj) if not isinstance(obj, type(torch)) else True
        self._undo.append((obj, name, getattr(obj, name), had))
        setattr(obj, name, value)

    def install(self) -> "Hooks":
        from sycl_points_tpu_torch.lio import lio_registration
        from sycl_points_tpu_torch.ops import cuda_knn
        from sycl_points_tpu_torch.registration import pipeline as reg_pipeline

        self._set(reg_pipeline, "align_streams", self._wrap_align(reg_pipeline.align_streams, "reg"))
        self._set(lio_registration, "align_streams", self._wrap_align(lio_registration.align_streams, "lio"))
        self._set(cuda_knn, "nn1_prepped_batched", self._wrap_knn(cuda_knn.nn1_prepped_batched, "nn1"))
        self._set(cuda_knn, "knn_k_batched", self._wrap_knn(cuda_knn.knn_k_batched, "knn_k"))
        for rank, f in _fleets(self.fleet):
            pcp = f._t.pc_processor
            self._set(pcp, "preprocess_streams", self._wrap_pre(pcp.preprocess_streams, rank))
            self._set(f, "_submap_step", self._wrap_map(f._submap_step, rank))
            self._set(f, "_resolve_one", self._wrap_span(f._resolve_one, "fleet.resolve"))
        return self

    def uninstall(self) -> None:
        for obj, name, value, had in reversed(self._undo):
            if had:
                setattr(obj, name, value)
            else:
                delattr(obj, name)
        self._undo.clear()

    def _local_rows(self, rank: int):
        """``(local row, global stream)`` of the frame's captured streams
        that shard ``rank`` holds."""
        b = self._shard_b
        return [(s - rank * b, s) for s in self.plan.streams(self.frame) if rank * b <= s < (rank + 1) * b]

    def _add(self, kind: str, item: dict) -> None:
        with self._lock:
            self.captures[kind].append(item)

    def _wrap_span(self, fn, name):
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped

    def _wrap_pre(self, fn, rank):
        def preprocess_streams(clouds, *a, **kw):
            self._local.rank = rank
            with self.span("fleet.preprocess"):
                out = fn(clouds, *a, **kw)
            for b, s in self._local_rows(rank):
                self._add("pre", {"frame": self.frame, "stream": s, **_rows(out, b)})
                points, mask = self.replay.scan(self.frame, s)
                self._add("raw", {"frame": self.frame, "stream": s, "points": points.to(out.points.device),
                                  "mask": mask.to(out.points.device)})
            return out
        return preprocess_streams

    def _wrap_align(self, fn, kind):
        def align_streams(source, target, target_knn, *a, **kw):
            with self.span("registration.align"):
                out = fn(source, target, target_knn, *a, **kw)
            rank = getattr(self._local, "rank", 0)
            for b, s in self._local_rows(rank):
                item = {"frame": self.frame, "stream": s, "src": _rows(source, b), "tgt": _rows(target, b)}
                if kind == "reg":
                    item["init"] = kw["initial_guess"][b].clone()
                else:  # the LIO solve: the prediction and the covariances it starts from
                    pred, P_pred, P_post = a[0], a[1], a[2]
                    item["pred"] = {k: v[b].clone() for k, v in pred._asdict().items()}
                    item["P_pred"], item["P_post"] = P_pred[b].clone(), P_post[b].clone()
                    item["update_bias"] = kw["update_bias"][b].clone()
                    item["state"] = {k: v[b].clone() for k, v in out.state._asdict().items()}
                    item["P_out"] = out.posterior_covariance[b].clone()
                self._add(kind, item)
            return out
        return align_streams

    def _wrap_map(self, fn, rank):
        def submap_step(map_state, target_prev, knn_prev, deskewed, T_eff, is_kf, n_desk, generators):
            with self.span("submap.step"):
                out = fn(map_state, target_prev, knn_prev, deskewed, T_eff, is_kf, n_desk, generators)
            if not self.plan.captured(self.frame) or out[2] is None:
                return out
            b0 = rank * self._shard_b
            local = [s - b0 for s in self.plan.order(self.frame) if b0 <= s < b0 + self._shard_b]
            kf = next((b for b in local if is_kf[b]), None)
            if kf is None:
                return out
            _, target, sampled, _ = out
            prev = {k: getattr(map_state, k)[kf].clone() for k in
                    ("used", "coords", "sum_pos", "count", "last_update", "frame")}
            self._add("map", {"frame": self.frame, "stream": b0 + kf, "prev": prev,
                              "sampled": _rows(sampled, kf, ("points", "mask")),
                              "input": _rows(deskewed, kf, ("points", "mask")), "T": T_eff[kf].clone(),
                              "out": _rows(target, kf)})
            return out
        return submap_step

    def _wrap_knn(self, fn, kind):
        def search(prep, queries, *a, **kw):
            if self.counting:
                key = id(prep.xyz)
                held = self.valid_rows.get(key)
                if held is None or held[0] is not prep.xyz:
                    with torch.profiler.record_function(COUNT_SPAN):
                        n = torch.isfinite(prep.xyz[:, 0, : prep.M]).sum(-1)
                    self.valid_rows[key] = (prep.xyz, n)
                k = a[0] if a else kw.get("k", 1)
                self.launches.append((kind, key, queries.shape[1], 1 if kind == "nn1" else k))
            return fn(prep, queries, *a, **kw)
        return search

    def end_counting(self) -> list:
        """Each counted launch as ``(kind, rows [B] of its target, Q, k)``
        on the host (one read, after the slice); the prepared targets are
        let go."""
        self.counting = False
        host = {key: n.cpu().numpy() for key, (_, n) in self.valid_rows.items()}
        self.valid_rows.clear()
        return [(kind, host[key], Q, k) for kind, key, Q, k in self.launches]
