"""The one traffic generator: a traffic file's parameters -> a fleet's replay.

A traffic mix is a JSON file under ``traffic/`` (found by the name a cell
gives). Every number of the replay comes from it and from ``--seed``:

- stream ``s`` drives in a world of its own: a ground plane, a cylinder wall
  and ``world.boxes`` boxes; the worlds are one fixed pool (drawn from
  ``POOL_SEED``) that ``--seed`` hands out to the streams in an order of its
  own, so every seed replays the same work; every box whose footprint lies
  within ``world.track_clearance_m`` of the track is taken out, so no stream
  drives into a box;
- every stream drives the radius ``track.radius_m`` figure-8, one loop in
  exactly ``track.loop_frames`` frames (``frame_dt_s`` apart), so the replay
  cycles without a jump; stream ``s`` starts ``s L / B`` frames into the loop,
  so the streams are at different places of it and take their keyframes at
  different frames;
- stream ``s``'s ``rays_azimuth x rays_rings`` ray pattern carries an
  azimuth jitter of its own, and every ray of every frame a range noise,
  both drawn on the device from the seed;
- one loop of scans is raycast on the device in batches of whole frames of
  all streams and kept there (:class:`Replay`): points ``[L, B, R, 3]`` in
  each sensor's frame and their mask;
- with ``imu_hz`` each stream gets the planar figure-8's body-frame IMU
  readings at its own place of the loop (a table of one loop made in
  set-up), fed per stream as users feed them.

The world and track math is a copy of ``sycl_points_tpu_torch/utils/
synthetic.py`` (the ground / wall / box slab raycast, the figure-8 and its
closed-form IMU), batched over frames and streams; the replay loop of
``sycl_points_tpu_torch/apps/fleet_replay.py`` is what the harness's window
does with it.
"""

from __future__ import annotations

import json
import math
from typing import NamedTuple

import numpy as np
import torch

GRAVITY = (0.0, 0.0, -9.80665)
POOL_SEED = 20241018  # the worlds' pool, the same for every seed


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def seed_words(seed: int, *more: int) -> list:
    """Entropy for numpy's SeedSequence: any whole number (negative ones
    too) folded to 64 bits, then ``more``."""
    return [int(seed) % (1 << 64), *more]


def torch_seed(seed: int, salt: int) -> int:
    """A torch generator seed from ``seed`` and a salt (63 bits)."""
    return int(np.random.SeedSequence(seed_words(seed, salt)).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


# ---- worlds ---------------------------------------------------------------------


def track_xy(radius: float, n: int) -> np.ndarray:
    """``n`` points ``[n, 2]`` evenly in the figure-8's parameter, one loop."""
    s = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    return np.stack([radius * np.sin(s), radius * np.sin(s) * np.cos(s)], 1)


def _clearance(track: np.ndarray, lo: np.ndarray, hi: np.ndarray, device) -> np.ndarray:
    """The least distance from the points ``track [P, 2]`` to each
    rectangle ``lo``-``hi`` ``[N, 2]``, in float64 torch on ``device``, in
    chunks of rectangles."""
    t = torch.as_tensor(track, dtype=torch.float64, device=device)
    out = []
    for i in range(0, len(lo), 2048):
        a = torch.as_tensor(lo[i : i + 2048], dtype=torch.float64, device=device)
        b = torch.as_tensor(hi[i : i + 2048], dtype=torch.float64, device=device)
        d = torch.clamp_min(torch.maximum(a[None] - t[:, None], t[:, None] - b[None]), 0.0)
        out.append(torch.hypot(d[..., 0], d[..., 1]).amin(0))
    return torch.cat(out).cpu().numpy()


def make_worlds(tp: dict, seed: int, device="cpu"):
    """Every stream's boxes: ``(lo [B, K, 3], hi [B, K, 3], ok [B, K])``
    float64 / bool numpy, ``K = world.boxes``; a box taken out is not ok.

    The worlds are one fixed pool, drawn from :data:`POOL_SEED`, that
    ``seed`` hands out to the streams in an order of its own: every seed
    replays the same work in another order. The track is sampled
    8 times a frame (under 7 cm apart), and a box is kept only when its
    sampled distance clears ``track_clearance_m`` by half that spacing."""
    w, B = tp["world"], tp["streams"]
    K = w["boxes"]
    lo = np.zeros((B, K, 3))
    hi = np.zeros((B, K, 3))
    order = np.random.default_rng(seed_words(seed, 3)).permutation(B)
    for s in range(B):
        rng = np.random.default_rng(seed_words(POOL_SEED, int(order[s])))
        c = rng.uniform(-w["extent_m"], w["extent_m"], size=(K, 2))
        half = rng.uniform(*w["half_m"], size=(K, 2))
        height = rng.uniform(*w["height_m"], size=K)
        lo[s, :, :2], hi[s, :, :2] = c - half, c + half
        hi[s, :, 2] = height
    track = track_xy(tp["track"]["radius_m"], 8 * tp["track"]["loop_frames"])
    spacing = np.linalg.norm(np.diff(track, axis=0, append=track[:1]), axis=1).max()
    d = _clearance(track, lo[..., :2].reshape(-1, 2), hi[..., :2].reshape(-1, 2), device)
    ok = (d > w["track_clearance_m"] + 0.5 * spacing).reshape(B, K)
    return lo, hi, ok


# ---- the track and its IMU ----------------------------------------------------------


def speed(tp: dict) -> float:
    """Metres a frame: one loop in ``loop_frames`` frames."""
    return 2.0 * np.pi * tp["track"]["radius_m"] / tp["track"]["loop_frames"]


def track_poses(tp: dict) -> np.ndarray:
    """``[L, 4, 4]`` float64: the sensor's pose at each frame of the loop
    (heading along the track, ``sensor_height_m`` up)."""
    r, L, h = tp["track"]["radius_m"], tp["track"]["loop_frames"], tp["track"]["sensor_height_m"]
    out = np.tile(np.eye(4), (L, 1, 1))
    for i in range(L):
        s = 2.0 * np.pi * i / L
        yaw = np.arctan2(np.cos(2 * s), np.cos(s))
        out[i, :3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        out[i, :3, 3] = [r * np.sin(s), r * np.sin(s) * np.cos(s), h]
    return out


def figure8_imu(tp: dict, t: float):
    """Body-frame ``(gyro [3], accel [3])`` of the planar figure-8 at time
    ``t`` (frame ``i`` at ``i frame_dt_s``), in closed form."""
    r, dt = tp["track"]["radius_m"], tp["frame_dt_s"]
    s_dot = speed(tp) / (dt * r)
    s = t * s_dot
    a_world = np.array([-r * np.sin(s) * s_dot**2, -2.0 * r * np.sin(2 * s) * s_dot**2, 0.0])
    dx, dy = np.cos(s), np.cos(2 * s)
    dx_d, dy_d = -np.sin(s) * s_dot, -2.0 * np.sin(2 * s) * s_dot
    yaw_dot = (dy_d * dx - dx_d * dy) / max(dx * dx + dy * dy, 1e-12)
    yaw = np.arctan2(dy, dx)
    c, si = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
    return np.array([0.0, 0.0, yaw_dot]), R.T @ (a_world - np.asarray(GRAVITY))


def phases(tp: dict) -> np.ndarray:
    """Each stream's first frame in the loop."""
    B, L = tp["streams"], tp["track"]["loop_frames"]
    return np.arange(B) * L // B


def imu_table(tp: dict):
    """``(gyro, accel)`` ``[L, K, 3]`` float32: the readings of the window
    that ends at loop frame ``j`` (``K`` readings from one frame before it),
    as the loop repeats."""
    L, dt = tp["track"]["loop_frames"], tp["frame_dt_s"]
    K = int(round(dt * tp["imu_hz"])) + 1
    g = np.zeros((L, K, 3), np.float32)
    a = np.zeros((L, K, 3), np.float32)
    for j in range(L):
        for k, t in enumerate(dt * j - dt + dt * np.arange(K) / (K - 1)):
            g[j, k], a[j, k] = figure8_imu(tp, t)
    return g, a


def imu_times(tp: dict, frame: int) -> np.ndarray:
    """The times of the readings fed before frame ``frame``: from the last
    frame's time (half a frame before the first) to this one's, both ends in,
    at ``imu_hz``."""
    dt = tp["frame_dt_s"]
    t = dt * frame
    t_from = max(t - dt, -0.5 * dt)
    n = max(int(round((t - t_from) * tp["imu_hz"])), 1)
    return t_from + (t - t_from) * np.arange(n + 1) / n


# ---- rays and the raycast ------------------------------------------------------------


def ray_dirs(tp: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Each stream's sensor-frame ray pattern ``[B, R, 3]`` (azimuth-major,
    HDL-64 elevation span over the rings), its azimuths jittered."""
    B, n_az, n_el = tp["streams"], tp["rays_azimuth"], tp["rays_rings"]
    az = torch.linspace(-math.pi, math.pi, n_az + 1, dtype=torch.float64, device=device)[:-1]
    el = torch.deg2rad(torch.linspace(*tp["elevation_deg"], n_el, dtype=torch.float64, device=device))
    jitter = torch.randn((B, n_az, n_el), generator=gen, device=device, dtype=torch.float32) * tp["az_jitter_rad"]
    a = az[None, :, None] + jitter.to(torch.float64)
    e = el[None, None, :].expand_as(a)
    d = torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a), torch.sin(e)], -1)
    return d.reshape(B, n_az * n_el, 3).to(torch.float32)


def raycast_frames(dirs_s, R, o, box_lo, box_hi, box_ok, wall_r: float) -> torch.Tensor:
    """First-hit range ``[F, B, R]`` (inf: nothing) of every stream's rays
    ``dirs_s [B, R, 3]`` cast from its poses ``R [F, B, 3, 3]``, ``o [F, B,
    3]`` into its boxes ``[B, K, 3]`` (those ``box_ok``), the ground and the
    wall."""
    d = torch.einsum("fbij,brj->fbri", R, dirs_s)  # world-frame directions
    ox, oy, oz = (o[:, :, i, None] for i in range(3))
    dx, dy, dz = d.unbind(-1)
    inf = torch.inf
    down = dz < -1e-6
    tg = torch.where(down, -oz / torch.where(down, dz, 1.0), inf)
    best = torch.where(tg > 0, tg, inf)
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - wall_r * wall_r
    disc = b * b - 4 * a * c
    hit = (disc > 0) & (a > 1e-9)
    tw = torch.where(hit, (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / torch.clamp_min(2 * a, 1e-9), inf)
    best = torch.minimum(best, torch.where(tw > 0, tw, inf))
    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, 1e-9)
    for k in range(box_lo.shape[1]):
        t0 = (box_lo[None, :, k, None, :] - o[:, :, None, :]) * inv
        t1 = (box_hi[None, :, k, None, :] - o[:, :, None, :]) * inv
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = (tmax >= torch.clamp_min(tmin, 1e-3)) & box_ok[None, :, k, None]
        best = torch.where(hit, torch.minimum(best, tmin), best)
    return best


def raycast_frames_triton(dirs_s, R, o, box_lo, box_hi, box_ok, wall_r: float) -> torch.Tensor:
    """:func:`raycast_frames` on the card in one Triton kernel: a ray a
    lane, its boxes in a loop, nothing between them in memory. Built at the
    first call (Triton's cache keeps it)."""
    kernel = _raycast_kernel()
    import triton

    F, B = R.shape[:2]
    n = dirs_s.shape[1]
    out = torch.empty((F, B, n), dtype=torch.float32, device=dirs_s.device)
    block = 256
    with torch.cuda.device(dirs_s.device):  # Triton launches on the current card
        kernel[(triton.cdiv(n, block), B, F)](
            dirs_s.contiguous(), R.contiguous(), o.contiguous(), box_lo.contiguous(), box_hi.contiguous(),
            box_ok.to(torch.float32).contiguous(), out, n, B, box_lo.shape[1], float(wall_r) ** 2, BLOCK=block)
    return out


_KERNEL = []


def _raycast_kernel():
    if _KERNEL:
        return _KERNEL[0]
    import triton
    import triton.language as tl

    @triton.jit
    def raycast_kernel(dirs, rot, org, lo, hi, ok, out, n, B, K, wall_r2, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        b = tl.program_id(1)
        f = tl.program_id(2)
        live = i < n
        d = dirs + (b * n + i) * 3
        sx = tl.load(d, mask=live, other=1.0)
        sy = tl.load(d + 1, mask=live, other=0.0)
        sz = tl.load(d + 2, mask=live, other=0.0)
        r = rot + (f * B + b) * 9
        ox = tl.load(org + (f * B + b) * 3)
        oy = tl.load(org + (f * B + b) * 3 + 1)
        oz = tl.load(org + (f * B + b) * 3 + 2)
        dx = tl.load(r) * sx + tl.load(r + 1) * sy + tl.load(r + 2) * sz
        dy = tl.load(r + 3) * sx + tl.load(r + 4) * sy + tl.load(r + 5) * sz
        dz = tl.load(r + 6) * sx + tl.load(r + 7) * sy + tl.load(r + 8) * sz
        inf = float("inf")
        down = dz < -1e-6
        tg = tl.where(down, -oz / tl.where(down, dz, 1.0), inf)
        best = tl.where(tg > 0, tg, inf)
        a = dx * dx + dy * dy
        bb = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - wall_r2
        disc = bb * bb - 4 * a * c
        tw = (-bb + tl.sqrt(tl.maximum(disc, 0.0))) / tl.maximum(2 * a, 1e-9)
        tw = tl.where((disc > 0) & (a > 1e-9) & (tw > 0), tw, inf)
        best = tl.minimum(best, tw)
        ix = 1.0 / tl.where(tl.abs(dx) > 1e-9, dx, 1e-9)
        iy = 1.0 / tl.where(tl.abs(dy) > 1e-9, dy, 1e-9)
        iz = 1.0 / tl.where(tl.abs(dz) > 1e-9, dz, 1e-9)
        for k in range(K):
            p = (b * K + k) * 3
            ax = (tl.load(lo + p) - ox) * ix
            bx = (tl.load(hi + p) - ox) * ix
            ay = (tl.load(lo + p + 1) - oy) * iy
            by = (tl.load(hi + p + 1) - oy) * iy
            az = (tl.load(lo + p + 2) - oz) * iz
            bz = (tl.load(hi + p + 2) - oz) * iz
            tmin = tl.maximum(tl.maximum(tl.minimum(ax, bx), tl.minimum(ay, by)), tl.minimum(az, bz))
            tmax = tl.minimum(tl.minimum(tl.maximum(ax, bx), tl.maximum(ay, by)), tl.maximum(az, bz))
            hit = (tmax >= tl.maximum(tmin, 1e-3)) & (tl.load(ok + b * K + k) > 0.5)
            best = tl.where(hit, tl.minimum(best, tmin), best)
        tl.store(out + (f * B + b) * n + i, best, mask=live)

    _KERNEL.append(raycast_kernel)
    return raycast_kernel


class Replay(NamedTuple):
    """One loop of a fleet's scans, each device's streams on that device."""

    points: list  # a [L, b, R, 3] float32 part a device, sensor frame (0 where masked)
    mask: list  # a [L, b, R] bool part a device
    poses: np.ndarray  # [L, 4, 4] float64, the true sensor poses of the loop
    phases: np.ndarray  # [B] each stream's first loop frame
    frame_dt: float
    warmup: int
    imu_hz: float

    @property
    def loop_frames(self) -> int:
        return self.points[0].shape[0]

    @property
    def streams(self) -> int:
        return sum(p.shape[1] for p in self.points)

    def time(self, frame: int) -> float:
        return self.frame_dt * frame

    def start_poses(self) -> np.ndarray:
        """``[B, 4, 4]`` float32: each stream's true pose at its first frame."""
        return self.poses[self.phases].astype(np.float32)

    def frame(self, f: int):
        """``(points [B, R, 3], mask [B, R])`` of every stream at frame ``f``,
        on the first device (views where there is one part)."""
        j = f % self.loop_frames
        if len(self.points) == 1:
            return self.points[0][j], self.mask[0][j]
        dev = self.points[0].device
        return (torch.cat([p[j].to(dev, non_blocking=True) for p in self.points]),
                torch.cat([m[j].to(dev, non_blocking=True) for m in self.mask]))

    def scan(self, f: int, stream: int):
        """``(points [R, 3], mask [R])`` of one stream at frame ``f``."""
        b = self.points[0].shape[1]
        j = f % self.loop_frames
        return self.points[stream // b][j, stream % b], self.mask[stream // b][j, stream % b]


def make_replay(tp: dict, seed: int, devices) -> Replay:
    """One loop of every stream's scans, raycast on ``devices`` (one device,
    or a list that the streams are split over evenly, each part drawn from
    its own generator)."""
    devices = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple)) else [devices])]
    B, L = tp["streams"], tp["track"]["loop_frames"]
    n = len(devices)
    if B % n:
        raise ValueError(f"{B} streams do not split over {n} devices")
    b = B // n
    R = tp["rays_azimuth"] * tp["rays_rings"]
    lo, hi, ok = make_worlds(tp, seed, devices[0])
    poses = track_poses(tp)
    ph = phases(tp)
    at = (np.arange(L)[:, None] + ph[None, :]) % L  # [L, B]: the loop frame stream s sees at frame j
    # about 2^25 rays a batch: large calls, a few GB of temporaries
    F = max(1, (1 << 25) // (b * R))
    noise_m, lo_m, hi_m = tp["range_noise_m"], tp["min_range_m"], tp["max_range_m"]
    all_points, all_mask = [], []
    for i, device in enumerate(devices):
        rows = slice(i * b, (i + 1) * b)
        gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1 if i == 0 else 1000 + i))
        dirs = ray_dirs(dict(tp, streams=b), gen, device)
        box_lo = torch.as_tensor(lo[rows], dtype=torch.float32, device=device)
        box_hi = torch.as_tensor(hi[rows], dtype=torch.float32, device=device)
        box_ok = torch.as_tensor(ok[rows], device=device)
        Rs = torch.as_tensor(poses[at[:, rows]][..., :3, :3], dtype=torch.float32, device=device)
        os_ = torch.as_tensor(poses[at[:, rows]][..., :3, 3], dtype=torch.float32, device=device)
        points = torch.empty((L, b, R, 3), dtype=torch.float32, device=device)
        mask = torch.empty((L, b, R), dtype=torch.bool, device=device)
        cast = raycast_frames_triton if device.type == "cuda" else raycast_frames
        for f0 in range(0, L, F):
            f1 = min(L, f0 + F)
            t = cast(dirs, Rs[f0:f1], os_[f0:f1], box_lo, box_hi, box_ok, tp["world"]["wall_radius_m"])
            t = t + noise_m * torch.randn(t.shape, generator=gen, device=device, dtype=torch.float32)
            valid = torch.isfinite(t) & (t > lo_m) & (t < hi_m)
            mask[f0:f1] = valid
            points[f0:f1] = torch.where(valid[..., None], dirs[None] * t[..., None], 0.0)
        all_points.append(points)
        all_mask.append(mask)
    return Replay(all_points, all_mask, poses, ph, tp["frame_dt_s"], tp["warmup_frames"],
                  float(tp.get("imu_hz", 0.0)))
