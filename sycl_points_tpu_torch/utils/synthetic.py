"""Synthetic HDL-64 scans raycast in PyTorch, on any device.

The world, the ray pattern and the trajectory come from
``benchmarks/synthetic_velodyne.py`` (numpy only). Its ``World.raycast``
runs in JAX; :func:`raycast` here is the same ground-plane / cylinder-wall /
box-slab math in PyTorch, so a scan pair can be made on the card without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_RAY_CHUNK = 1 << 15


def raycast(world, origin, dirs: torch.Tensor) -> torch.Tensor:
    """First-hit distance per ray (inf = sky), float32 on ``dirs``' device.

    ``world`` is a ``synthetic_velodyne.World``; ``origin`` is one ``[3]``
    position or per-ray ``[R, 3]`` positions; ``dirs`` is ``[R, 3]``."""
    dev = dirs.device
    dirs = dirs.to(torch.float32)
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    origin = origin.expand(dirs.shape[0], 3)
    box_lo = torch.as_tensor(world.box_lo, dtype=torch.float32, device=dev)
    box_hi = torch.as_tensor(world.box_hi, dtype=torch.float32, device=dev)
    return torch.cat([
        _raycast_chunk(origin[s : s + _RAY_CHUNK], dirs[s : s + _RAY_CHUNK], box_lo, box_hi, world.wall_r**2)
        for s in range(0, dirs.shape[0], _RAY_CHUNK)
    ])


def _raycast_chunk(origin, dirs, box_lo, box_hi, wall_r2):
    inf = torch.inf
    dz = dirs[:, 2]
    m = dz < -1e-6
    tg = torch.where(m, -origin[:, 2] / torch.where(m, dz, 1.0), inf)
    t_best = torch.where(tg > 0, tg, inf)

    # cylinder x^2 + y^2 = wall_r^2
    ox, oy = origin[:, 0], origin[:, 1]
    dx, dy = dirs[:, 0], dirs[:, 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - wall_r2
    disc = b * b - 4 * a * c
    ok = (disc > 0) & (a > 1e-9)
    tw = torch.where(
        ok, (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / torch.clamp_min(2 * a, 1e-9), inf
    )
    t_best = torch.minimum(t_best, torch.where(tw > 0, tw, inf))

    # boxes, slab method: [R, n_boxes]
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-9, dirs, 1e-9)
    t0 = (box_lo[None, :, :] - origin[:, None, :]) * inv[:, None, :]
    t1 = (box_hi[None, :, :] - origin[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t0, t1).amax(2)
    tmax = torch.maximum(t0, t1).amin(2)
    hit = tmax >= torch.clamp_min(tmin, 1e-3)
    tb = torch.where(hit, tmin, inf)
    return torch.minimum(t_best, tb.amin(1))


def scan_at(world, T: np.ndarray, n_az=2048, n_rings=64, max_range=80.0, noise=0.01,
            seed=0, device: torch.device | str = "cpu") -> np.ndarray:
    """Sensor-frame point cloud ``[N, 3]`` float32, raycast on ``device`` from
    pose ``T`` (4x4). The same rays, range gate and noise stream as
    ``synthetic_velodyne.scan_at``; sky and out-of-range rays are dropped."""
    from benchmarks.synthetic_velodyne import hdl64_dirs

    dirs_s = hdl64_dirs(n_az, n_rings, seed)
    dirs_w = dirs_s @ T[:3, :3].T.astype(np.float32)
    t = raycast(world, T[:3, 3], torch.from_numpy(dirs_w).to(device)).cpu().numpy()
    ok = np.isfinite(t) & (t > 1.0) & (t < max_range)
    rng = np.random.default_rng(seed + 1)
    t = t[ok] + rng.normal(scale=noise, size=ok.sum())
    return (dirs_s[ok] * t[:, None].astype(np.float32)).astype(np.float32)
