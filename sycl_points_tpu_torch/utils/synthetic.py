"""Synthetic HDL-64 scans raycast in PyTorch, on any device.

The port's own copy of the numpy parts of the JAX package's synthetic
Velodyne generator (``benchmarks/synthetic_velodyne.py``): the
:class:`World`, the ray pattern :func:`hdl64_dirs`, the figure-8 trajectory
with its velocity and the IMU that flies it (planar and 3-D excited), and
the fleet benchmark's per-stream trajectories (:func:`fleet_trajectories`).
:func:`raycast` is the same ground-plane / cylinder-wall / box-slab math as
the JAX ``World.raycast``, in PyTorch, so scans can be made on the card; a
motion-distorted scan (:func:`scan_at_distorted`) casts each azimuth column
from its own sweep pose. :func:`return_intensities` gives a scan 8-bit return
intensities (the JAX generator makes none).
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.utils import lie_np

_RAY_CHUNK = 1 << 15


class World:
    """Ground plane at z=0, cylinder wall at ``wall_r``, K random boxes.

    ``hard=True`` builds the clutter world: ~8x the box density, 250 thin
    poles and 300 small scatterers, all kept 2.5 m clear of the figure-8
    track. The random streams are the reference's, draw for draw, so the
    same seed gives the same world."""

    def __init__(self, seed=42, n_boxes=40, extent=45.0, wall_r=50.0, hard=False):
        rng = np.random.default_rng(seed)
        self.wall_r = wall_r
        if not hard:
            c = rng.uniform(-extent, extent, size=(n_boxes, 2))
            c = c[np.linalg.norm(c, axis=1) > 6.0]  # clear the origin path
            n = len(c)
            half = rng.uniform(0.5, 3.0, size=(n, 2))
            self.box_lo = np.concatenate([c - half, np.zeros((n, 1))], axis=1)
            self.box_hi = np.concatenate([c + half, rng.uniform(1.0, 6.0, size=(n, 1))], axis=1)
            return

        n_boxes = max(n_boxes, 300)
        c = rng.uniform(-extent, extent, size=(n_boxes, 2))
        half = rng.uniform(0.5, 3.0, size=(n_boxes, 2))
        hz = rng.uniform(1.0, 6.0, size=(n_boxes, 1))
        pc = rng.uniform(-extent, extent, size=(250, 2))
        ph = rng.uniform(0.05, 0.2, size=(250, 1)) * np.ones((1, 2))
        pz = rng.uniform(2.0, 8.0, size=(250, 1))
        sc = rng.uniform(-extent, extent, size=(300, 2))
        sh = rng.uniform(0.1, 0.5, size=(300, 1)) * np.ones((1, 2))
        sz = rng.uniform(0.2, 1.2, size=(300, 1))
        c = np.concatenate([c, pc, sc])
        half = np.concatenate([half, ph, sh])
        hz = np.concatenate([hz, pz, sz])
        # clear 2.5 m around the figure-8 track (radius-18 lemniscate)
        s = np.linspace(0, 2 * np.pi, 512)
        track = np.stack([18.0 * np.sin(s), 18.0 * np.sin(s) * np.cos(s)], 1)
        d = np.min(np.linalg.norm(c[:, None, :] - track[None], axis=-1), axis=1)
        keep = d > 2.5
        c, half, hz = c[keep], half[keep], hz[keep]
        n = len(c)
        self.box_lo = np.concatenate([c - half, np.zeros((n, 1))], axis=1)
        self.box_hi = np.concatenate([c + half, hz], axis=1)


def hdl64_dirs(n_az=2048, n_rings=64, seed=0):
    """Sensor-frame ray directions, HDL-64-like (elevation -24.8..+2 deg),
    with a small per-shot azimuth jitter so scans from one pose differ."""
    rng = np.random.default_rng(seed)
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el = np.deg2rad(np.linspace(-24.8, 2.0, n_rings))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    azg = azg + rng.normal(scale=2e-4, size=azg.shape)
    ce = np.cos(elg)
    return np.stack([ce * np.cos(azg), ce * np.sin(azg), np.sin(elg)], axis=-1).reshape(-1, 3).astype(np.float32)


def figure8_pose_3d(t: float, radius=18.0, speed=0.35, frame_dt=0.1):
    """Figure-8 pose at continuous time ``t`` with z-bobbing and roll/pitch
    oscillation (float64 ``[4, 4]``)."""
    s_dot = speed / (frame_dt * radius)
    s = t * s_dot
    x = radius * np.sin(s)
    y = radius * np.sin(s) * np.cos(s)
    z = 1.8 + 0.4 * np.sin(2 * np.pi * 0.4 * t)
    yaw = np.arctan2(np.cos(2 * s), np.cos(s))
    roll = 0.25 * np.sin(2 * np.pi * 0.5 * t)
    pitch = 0.2 * np.sin(2 * np.pi * 0.35 * t + 1.0)

    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    Rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [x, y, z]
    return T


def figure8_imu_3d(t: float, radius=18.0, speed=0.35, frame_dt=0.1, gravity=(0.0, 0.0, -9.80665), h=5e-4):
    """Body-frame ``(gyro[3], accel[3])`` consistent with
    :func:`figure8_pose_3d`, by central differences of the pose (float64)."""
    Tm = figure8_pose_3d(t - h, radius, speed, frame_dt)
    T0 = figure8_pose_3d(t, radius, speed, frame_dt)
    Tp = figure8_pose_3d(t + h, radius, speed, frame_dt)
    R0 = T0[:3, :3]
    dR = (Tp[:3, :3] - Tm[:3, :3]) / (2 * h)
    W = R0.T @ dR  # skew(omega_body)
    gyro = np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]]) * 0.5
    a_world = (Tp[:3, 3] - 2 * T0[:3, 3] + Tm[:3, 3]) / (h * h)
    accel = R0.T @ (a_world - np.asarray(gravity))
    return gyro, accel


def figure8_velocity(t: float, radius=18.0, speed=0.35, frame_dt=0.1, excite3d=False, h=5e-4):
    """World-frame velocity of the figure-8 at ``t``: the state a replay that
    starts in motion seeds its filter with."""
    if not excite3d:
        s_dot = speed / (frame_dt * radius)
        s = t * s_dot
        return np.array([radius * np.cos(s) * s_dot, radius * np.cos(2 * s) * s_dot, 0.0])
    return (
        figure8_pose_3d(t + h, radius, speed, frame_dt)[:3, 3]
        - figure8_pose_3d(t - h, radius, speed, frame_dt)[:3, 3]
    ) / (2 * h)


def figure8_imu(t: float, radius=18.0, speed=0.35, frame_dt=0.1, gravity=(0.0, 0.0, -9.80665)):
    """Body-frame ``(gyro[3], accel[3])`` of the planar figure-8 at ``t``
    (frame ``i`` sits at ``t = frame_dt * i``), in closed form: the gyro is
    the yaw rate about z, the accelerometer reads ``R^T (a_world - g)``."""
    s_dot = speed / (frame_dt * radius)
    s = t * s_dot
    x_dd = -radius * np.sin(s) * s_dot**2
    y_dd = -2.0 * radius * np.sin(2 * s) * s_dot**2
    a_world = np.array([x_dd, y_dd, 0.0])
    dx, dy = np.cos(s), np.cos(2 * s)
    dx_d, dy_d = -np.sin(s) * s_dot, -2.0 * np.sin(2 * s) * s_dot
    denom = max(dx * dx + dy * dy, 1e-12)
    yaw_dot = (dy_d * dx - dx_d * dy) / denom
    yaw = np.arctan2(dy, dx)
    c, si = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
    gyro = np.array([0.0, 0.0, yaw_dot])
    accel = R.T @ (a_world - np.asarray(gravity))
    return gyro, accel


def figure8_trajectory(n_frames: int, radius=18.0, speed=0.35, excite3d=False):
    """``n_frames`` SE(3) poses (sensor z up at 1.8 m) along a figure-8, one
    per 0.1 s frame; ``excite3d`` samples :func:`figure8_pose_3d`."""
    if excite3d:
        return [figure8_pose_3d(0.1 * i, radius, speed) for i in range(n_frames)]
    poses = []
    for i in range(n_frames):
        s = i * speed / radius
        yaw = np.arctan2(np.cos(2 * s), np.cos(s))  # heading from the velocity
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        T[:3, 3] = [radius * np.sin(s), radius * np.sin(s) * np.cos(s), 1.8]
        poses.append(T)
    return poses


def fleet_trajectories(n_streams: int, n_frames: int, speed: float = 0.35):
    """The fleet benchmark's per-stream trajectories (the JAX package's
    ``benchmarks/bench_fleet.py``): the figure-8 of :func:`figure8_trajectory`
    turned by yaw ``2 pi s / n_streams`` and moved ``3.0 (s mod 4)`` m along
    x for stream ``s``. Returns ``(trajs [B][n_frames] of [4, 4] float32,
    the per-stream transforms [B, 4, 4])``."""
    base = figure8_trajectory(n_frames, speed=speed)
    trajs, starts = [], []
    for s in range(n_streams):
        yaw = 2.0 * np.pi * s / n_streams
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.eye(4, dtype=np.float32)
        R[:3, :3] = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]], np.float32)
        R[0, 3] = 3.0 * (s % 4)
        trajs.append([(R @ T).astype(np.float32) for T in base])
        starts.append(R)
    return trajs, np.stack(starts)


def raycast(world, origin, dirs: torch.Tensor) -> torch.Tensor:
    """First-hit distance per ray (inf = sky), float32 on ``dirs``' device.

    ``world`` is a :class:`World`; ``origin`` is one ``[3]``
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
            seed=0, device: torch.device | str = "cuda") -> np.ndarray:
    """Sensor-frame point cloud ``[N, 3]`` float32, raycast on ``device`` (the
    card unless the caller asks for the CPU) from pose ``T`` (4x4). The same
    rays, range gate and noise stream as the JAX package's synthetic
    ``scan_at``; sky and out-of-range rays are dropped."""
    device = require_device(device)
    dirs_s = hdl64_dirs(n_az, n_rings, seed)
    dirs_w = dirs_s @ T[:3, :3].T.astype(np.float32)
    t = raycast(world, T[:3, 3], torch.from_numpy(dirs_w).to(device)).cpu().numpy()
    ok = np.isfinite(t) & (t > 1.0) & (t < max_range)
    rng = np.random.default_rng(seed + 1)
    t = t[ok] + rng.normal(scale=noise, size=ok.sum())
    return (dirs_s[ok] * t[:, None].astype(np.float32)).astype(np.float32)


def return_intensities(points: np.ndarray, seed: int = 0) -> np.ndarray:
    """8-bit raw return intensities of sensor-frame ``points`` ``[N, 3]``,
    float32: a seeded surface reflectivity in [0.05, 1] times
    ``1000 / range^2``, capped at 255, so that the parameter tree's default
    intensity correction (``1e-3 range^2``) gives the reflectivity back
    beyond 2 m."""
    r2 = np.maximum((np.asarray(points, np.float64) ** 2).sum(1), 1e-12)
    refl = np.random.default_rng(seed + 2).uniform(0.05, 1.0, len(r2))
    return np.minimum(refl * 1000.0 / r2, 255.0).astype(np.float32)


def scan_at_distorted(world, T_start: np.ndarray, T_end: np.ndarray, n_az=2048, n_rings=64, max_range=80.0,
                      noise=0.01, seed=0, scan_duration_ms=100.0, device: torch.device | str = "cuda"):
    """A motion-distorted scan with per-point timestamps, raycast on
    ``device`` (the card unless the caller asks for the CPU).

    Azimuth column ``j`` (time fraction ``f = j / n_az``) is cast from the
    sweep pose ``T_start exp(f log(T_start^-1 T_end))`` and its returns are
    written in that column's own sensor frame, as a spinning LiDAR's firmware
    assembles them. Returns ``(points [N, 3], timestamp_offsets_ms [N])``,
    float32 numpy, with the rays, range gate and noise stream of ``scan_at``.
    """
    device = require_device(device)
    dirs_s = hdl64_dirs(n_az, n_rings, seed)  # azimuth-major: ray = j * n_rings + e
    xi = lie_np.se3_log(np.linalg.inv(T_start) @ T_end)
    fracs = np.arange(n_az, dtype=np.float64) / n_az
    col_T = np.stack([T_start @ lie_np.se3_exp(f * xi) for f in fracs])
    dirs_w = np.einsum("jab,jrb->jra", col_T[:, :3, :3], dirs_s.reshape(n_az, n_rings, 3)).reshape(-1, 3)
    origins = np.repeat(col_T[:, :3, 3], n_rings, axis=0)
    t = raycast(world, origins, torch.from_numpy(dirs_w.astype(np.float32)).to(device)).cpu().numpy()
    t_ms = np.repeat(fracs * scan_duration_ms, n_rings)
    ok = np.isfinite(t) & (t > 1.0) & (t < max_range)
    rng = np.random.default_rng(seed + 1)
    t = t[ok] + rng.normal(scale=noise, size=ok.sum())
    pts = (dirs_s[ok] * t[:, None].astype(np.float32)).astype(np.float32)
    return pts, t_ms[ok].astype(np.float32)
