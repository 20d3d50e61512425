"""PointCloud: a fixed-capacity, masked struct-of-arrays container.

Counterpart of :mod:`sycl_points_tpu.points.point_cloud` with the same fields
and semantics: every attribute has ``capacity`` rows, ``mask`` marks the valid
ones, filters flip mask bits and compaction is an explicit gather. Tensors
live on whatever device they were made on; every op here runs there.

Attribute layout:
  * ``points``            ``[N, 3] float32``
  * ``mask``              ``[N]    bool``  (True = valid point)
  * ``covs``              ``[N, 3, 3]``
  * ``normals``           ``[N, 3]``
  * ``rgb``               ``[N, 4]`` in [0, 1]
  * ``intensities``       ``[N]``
  * ``timestamp_offsets`` ``[N]``  milliseconds from scan start

A fleet of ``B`` streams holds one cloud a stream in one container with a
leading stream axis (``points [B, N, 3]``, ``mask [B, N]``, ...):
``capacity`` is then ``N`` and ``count()`` is ``[B]``.
:func:`flatten_streams` / :func:`unflatten_streams` move between that and
one ``[B * N]`` cloud, for the row-wise ops that need no stream boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device

_OPTIONAL_FIELDS = ("covs", "normals", "rgb", "intensities", "timestamp_offsets")


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_capacity_for(n: int, lane: int = 256) -> int:
    """Bucketed padded capacity: the next of four tiers per power of two
    (1, 1.25, 1.5, 1.75 times), aligned to ``lane``."""
    if n <= lane:
        return lane
    p = 1 << (int(n - 1)).bit_length()
    for frac in (5, 6, 7):
        tier = (p // 2) + (p // 8) * (frac - 4)
        if n <= tier:
            return round_up(tier, lane)
    return round_up(p, lane)


@dataclasses.dataclass(frozen=True)
class PointCloud:
    points: torch.Tensor
    mask: torch.Tensor
    covs: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None
    rgb: Optional[torch.Tensor] = None
    intensities: Optional[torch.Tensor] = None
    timestamp_offsets: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def has_cov(self) -> bool:
        return self.covs is not None

    def has_normal(self) -> bool:
        return self.normals is not None

    def has_rgb(self) -> bool:
        return self.rgb is not None

    def has_intensity(self) -> bool:
        return self.intensities is not None

    def has_timestamps(self) -> bool:
        return self.timestamp_offsets is not None

    def count(self) -> torch.Tensor:
        """Number of valid points (0-dim int tensor on the cloud's device;
        ``[B]`` for a fleet's cloud)."""
        return self.mask.sum(-1, dtype=torch.int32)

    def replace(self, **kwargs) -> "PointCloud":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        covs: Optional[np.ndarray] = None,
        normals: Optional[np.ndarray] = None,
        rgb: Optional[np.ndarray] = None,
        intensities: Optional[np.ndarray] = None,
        timestamp_offsets: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device: torch.device | str = "cuda",
    ) -> "PointCloud":
        """Build a padded cloud on ``device`` (the card unless the caller asks
        for the CPU) from host arrays."""
        device = require_device(device)
        n = int(points.shape[0])
        cap = capacity if capacity is not None else pad_capacity_for(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")

        def pad(arr, shape_tail):
            out = np.zeros((cap,) + shape_tail, dtype=np.float32)
            out[:n] = arr.reshape((n,) + shape_tail).astype(np.float32)
            return torch.from_numpy(out).to(device)

        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return PointCloud(
            points=pad(points[:, :3], (3,)),
            mask=torch.from_numpy(mask).to(device),
            covs=None if covs is None else pad(covs[..., :3, :3], (3, 3)),
            normals=None if normals is None else pad(normals[:, :3], (3,)),
            rgb=None if rgb is None else pad(rgb[:, :4], (4,)),
            intensities=None if intensities is None else pad(intensities, ()),
            timestamp_offsets=None
            if timestamp_offsets is None
            else pad(timestamp_offsets, ()),
        )

    def to_numpy(self, compacted: bool = True) -> dict:
        """Copy to host as a numpy dict; drops padding when ``compacted``."""
        mask = self.mask.cpu().numpy()
        sel = mask if compacted else np.ones_like(mask)
        out = {"points": self.points.cpu().numpy()[sel]}
        for name in _OPTIONAL_FIELDS:
            arr = getattr(self, name)
            if arr is not None:
                out[name] = arr.cpu().numpy()[sel]
        return out


def _fields(cloud: PointCloud) -> dict:
    return {f.name: getattr(cloud, f.name) for f in dataclasses.fields(cloud)}


def flatten_streams(cloud: PointCloud) -> PointCloud:
    """A fleet's cloud ``[B, N, ...]`` as one ``[B * N, ...]`` cloud (views)."""
    return PointCloud(**{k: None if v is None else v.reshape((-1,) + v.shape[2:]) for k, v in _fields(cloud).items()})


def unflatten_streams(cloud: PointCloud, streams: int) -> PointCloud:
    """The inverse of :func:`flatten_streams`: ``[B * N, ...]`` as ``[B, N, ...]``."""
    return PointCloud(**{k: None if v is None else v.reshape((streams, -1) + v.shape[1:])
                         for k, v in _fields(cloud).items()})


def stream_offsets(streams: int, rows: int, device) -> torch.Tensor:
    """``[B, 1]`` int64: the first flat row of each stream of ``rows`` rows."""
    return torch.arange(streams, device=device)[:, None] * rows


def gather_streams(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[b, ...]`` of stream ``b`` of ``values [B, M, ...]``:
    ``values[b][idx[b]]`` for every stream, in one gather."""
    B, M = values.shape[:2]
    flat = values.reshape((B * M,) + values.shape[2:])
    off = stream_offsets(B, M, values.device).reshape((B,) + (1,) * (idx.dim() - 1))
    return flat[(idx.long() + off).reshape(-1)].reshape(idx.shape + values.shape[2:])


def compact_device(cloud: PointCloud, out_capacity: Optional[int] = None) -> PointCloud:
    """Move valid points to the front, in order, keeping a static capacity
    (of every stream, for a fleet's cloud).

    Each valid row goes to its exclusive-prefix-sum slot; rows past
    ``out_capacity`` and invalid rows go to one spare row that is cut off,
    so nothing waits on the host.
    """
    out_cap = out_capacity or cloud.capacity
    m = cloud.mask.to(torch.int64)
    csum = torch.cumsum(m, -1)
    n_valid = torch.clamp_max(csum[..., -1:], out_cap)
    new_mask = torch.arange(out_cap, device=cloud.device) < n_valid
    tgt = torch.where(cloud.mask, csum - m, out_cap).clamp_max(out_cap)
    lead = cloud.mask.shape[:-1]
    if lead:
        new_mask = new_mask.reshape(lead + (out_cap,))
        tgt = (tgt + stream_offsets(lead[0], out_cap + 1, cloud.device)).reshape(-1)
    else:
        new_mask = new_mask.reshape(out_cap)

    def take(arr):
        if arr is None:
            return None
        tail = arr.shape[len(lead) + 1:]
        rows = (lead[0] if lead else 1) * (out_cap + 1)
        out = torch.zeros((rows,) + tail, dtype=arr.dtype, device=arr.device)
        out.index_copy_(0, tgt, arr.reshape((-1,) + tail))
        return out.reshape(lead + (out_cap + 1,) + tail).narrow(len(lead), 0, out_cap)

    return PointCloud(
        points=take(cloud.points),
        mask=new_mask,
        **{name: take(getattr(cloud, name)) for name in _OPTIONAL_FIELDS},
    )


def filter_by_mask(cloud: PointCloud, keep: torch.Tensor) -> PointCloud:
    """Mask out points where ``keep`` is False (no data movement)."""
    return cloud.replace(mask=cloud.mask & keep)


def merge_with_timestamps(a: PointCloud, b: PointCloud, a_start_ms=0.0, b_start_ms=0.0):
    """:func:`merge` with the reference's timestamp-base shift: the merged
    cloud starts at ``min(a_start_ms, b_start_ms)`` and each side's offsets
    move by its start's distance from it; if either side has no timestamps,
    the merged cloud has none. Returns ``(merged, start_ms)``, ``start_ms`` a
    0-dim float32 tensor on the clouds' device when both have timestamps,
    else the start of the side that has them (0.0 for neither)."""
    a_has, b_has = a.has_timestamps(), b.has_timestamps()
    if not (a_has and b_has):
        m = merge(a, b).replace(timestamp_offsets=None)
        return m, a_start_ms if a_has else (b_start_ms if b_has else 0.0)
    a_start = torch.as_tensor(a_start_ms, dtype=torch.float32, device=a.device)
    b_start = torch.as_tensor(b_start_ms, dtype=torch.float32, device=a.device)
    start = torch.minimum(a_start, b_start)
    return merge(a.replace(timestamp_offsets=a.timestamp_offsets + (a_start - start)),
                 b.replace(timestamp_offsets=b.timestamp_offsets + (b_start - start))), start


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds; capacities add. An attribute present in only
    one cloud is zero-filled for the other. Timestamp offsets concatenate as
    they are: :func:`merge_with_timestamps` shifts clouds of different start
    times to one base."""

    def cat(x, y):
        if x is None and y is None:
            return None
        if x is None:
            x = torch.zeros((a.capacity,) + y.shape[1:], dtype=y.dtype, device=y.device)
        if y is None:
            y = torch.zeros((b.capacity,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return torch.cat([x, y], 0)

    return PointCloud(
        points=torch.cat([a.points, b.points], 0),
        mask=torch.cat([a.mask, b.mask], 0),
        **{name: cat(getattr(a, name), getattr(b, name)) for name in _OPTIONAL_FIELDS},
    )
