"""On-manifold IMU preintegration (Forster-style, midpoint / RK2).

Counterpart of :mod:`sycl_points_tpu.imu.preintegration`: measurement
windows with boundary interpolation, bias-linearized midpoint integration
with first-order bias Jacobians, 15x15 error-state covariance propagation
(ordering [dp, dphi, dv, dba, dbg]), first-order bias correction, and the
absolute / relative pose prediction with gravity and initial-velocity
compensation.

A window of S padded steps integrates in the parallel-prefix form
(:func:`_parallel_prefix_integrate`): every quantity of the recurrence is a
closed form over prefix products, and the two products that need a scan (the
rotation prefixes and the covariance's ``(F, Q)`` pairs) run as a log-depth
doubling scan, ceil(log2 S) rounds of batched ``torch.matmul``. It takes B
windows at once (a fleet's ``[B, S]``, each with its own biases and start
rotation); one window runs as the stream form with one stream, so that a
window alone and the same window as stream b of a fleet give the same bits. The
sequential recurrence (:func:`_integrate_scan`, S steps of small ops) is the
plain reference the parallel form is held to; no pipeline calls it.

The host-side helpers (:class:`IMUMeasurement`, the window builders,
:func:`pack_steps`) are this package's own copies of the JAX module's numpy
code; a frame's whole window goes to the device as one ``[S, 14]`` upload.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.smallmat import matvec3
from sycl_points_tpu_torch.utils.sync import to_device, to_host

GRAVITY = (0.0, 0.0, -9.80665)
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class IMUPreintegrationParams:
    gravity: tuple = GRAVITY
    accel_scale: float = 1.0
    gyro_noise_density: float = 0.0  # [rad/s/sqrt(Hz)]
    accel_noise_density: float = 0.0  # [m/s^2/sqrt(Hz)]
    gyro_bias_rw_density: float = 0.0  # [rad/s^2/sqrt(Hz)]
    accel_bias_rw_density: float = 0.0  # [m/s^3/sqrt(Hz)]

    def has_noise(self) -> bool:
        return (self.gyro_noise_density > 0.0 or self.accel_noise_density > 0.0
                or self.gyro_bias_rw_density > 0.0 or self.accel_bias_rw_density > 0.0)


class PreintegrationState(NamedTuple):
    Delta_R: torch.Tensor  # [3, 3]
    Delta_v: torch.Tensor  # [3]
    Delta_p: torch.Tensor  # [3]
    dt_total: torch.Tensor  # scalar
    J_R_bg: torch.Tensor  # [3, 3]
    J_v_bg: torch.Tensor
    J_v_ba: torch.Tensor
    J_p_bg: torch.Tensor
    J_p_ba: torch.Tensor
    covariance: torch.Tensor  # [15, 15]


def init_state(initial_covariance: Optional[torch.Tensor] = None,
               device: torch.device | str = "cuda") -> PreintegrationState:
    """The empty window; on ``initial_covariance``'s device when one is
    given, and one a stream for a fleet's covariances ``[B, 15, 15]``."""
    dev = initial_covariance.device if initial_covariance is not None else require_device(device)
    lead = () if initial_covariance is None else tuple(initial_covariance.shape[:-2])
    z3 = torch.zeros(lead + (3,), dtype=_F32, device=dev)
    z33 = torch.zeros(lead + (3, 3), dtype=_F32, device=dev)
    return PreintegrationState(
        Delta_R=torch.eye(3, dtype=_F32, device=dev).expand(lead + (3, 3)), Delta_v=z3, Delta_p=z3,
        dt_total=torch.zeros(lead, dtype=_F32, device=dev),
        J_R_bg=z33, J_v_bg=z33, J_v_ba=z33, J_p_bg=z33, J_p_ba=z33,
        covariance=torch.zeros((15, 15), dtype=_F32, device=dev) if initial_covariance is None
        else initial_covariance,
    )


def right_jacobian_so3(phi: torch.Tensor) -> torch.Tensor:
    """Jr(phi) ``[..., 3, 3]`` with the small-angle Taylor branch."""
    theta_sq = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta_sq, 1e-30))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    S = lie.skew(phi)
    S2 = phi[..., :, None] * phi[..., None, :] - theta_sq[..., None, None] * eye
    small = theta < 1e-4
    A = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / torch.clamp_min(theta_sq, 1e-30))
    B = torch.where(small, 1.0 / 6.0, (theta - torch.sin(theta)) / torch.clamp_min(theta_sq * theta, 1e-30))
    return eye - A[..., None, None] * S + B[..., None, None] * S2


def _rot(phi: torch.Tensor) -> torch.Tensor:
    return lie.quat_to_matrix(lie.so3_exp(phi))


def _blocks(rows, shape, dev) -> torch.Tensor:
    """A ``[*shape, 3R, 3C]`` matrix from a grid of 3x3 blocks; a block is a
    tensor ``[*shape, 3, 3]``, ``"I"`` or ``None`` (zero)."""
    eye = torch.eye(3, dtype=_F32, device=dev).expand(*shape, 3, 3)
    zero = torch.zeros((*shape, 3, 3), dtype=_F32, device=dev)

    def block(b):
        if b is None:
            return zero
        if isinstance(b, str):
            return eye
        return b.expand(*shape, 3, 3)

    return torch.cat([torch.cat([block(b) for b in row], dim=-1) for row in rows], dim=-2)


def _noise_density(params: IMUPreintegrationParams, dt: torch.Tensor) -> torch.Tensor:
    """The diagonal of the per-step noise covariance ``[..., 12]``:
    accel, gyro, accel-bias walk, gyro-bias walk."""
    dt_safe = torch.clamp_min(dt, 1e-9)[..., None]
    ones = torch.ones(3, dtype=_F32, device=dt.device)
    return torch.cat([
        ones * (params.accel_noise_density**2 / dt_safe), ones * (params.gyro_noise_density**2 / dt_safe),
        ones * (params.accel_bias_rw_density**2 * dt_safe), ones * (params.gyro_bias_rw_density**2 * dt_safe),
    ], dim=-1)


def _transition(dtc, R_world_mid, skew_a, rot_err_to_mid, gyro_bias_to_mid, R_step, Jr, shape, dev):
    """The 15x15 error-state transition F of one step (``[*shape, 15, 15]``)."""
    RWS = R_world_mid @ skew_a
    dt2 = dtc * dtc
    return _blocks([
        ["I", -0.5 * (RWS @ rot_err_to_mid) * dt2, dtc * torch.eye(3, dtype=_F32, device=dev),
         -0.5 * R_world_mid * dt2, -0.5 * (RWS @ gyro_bias_to_mid) * dt2],
        [None, R_step.transpose(-1, -2), None, None, -Jr * dtc],
        [None, -(RWS @ rot_err_to_mid) * dtc, "I", -R_world_mid * dtc, -(RWS @ gyro_bias_to_mid) * dtc],
        [None, None, None, "I", None],
        [None, None, None, None, "I"],
    ], shape, dev)


def _noise_input(dtc, R_world_mid, skew_a, Jr, Jr_half, shape, dev):
    """The 15x12 noise input G of one step (``[*shape, 15, 12]``)."""
    RWS = R_world_mid @ skew_a
    dt2 = dtc * dtc
    return _blocks([
        [-0.5 * R_world_mid * dt2, 0.25 * (RWS @ Jr_half) * dt2 * dtc, None, None],
        [None, -Jr * dtc, None, None],
        [-R_world_mid * dtc, 0.5 * (RWS @ Jr_half) * dt2, None, None],
        [None, None, "I", None],
        [None, None, None, "I"],
    ], shape, dev)


def _integrate_scan(params: IMUPreintegrationParams, state: PreintegrationState, dt, omega0, omega1, accel0,
                    accel1, valid, gyro_bias, accel_bias, R_world_body=None):
    """The midpoint recurrence one step at a time: the plain reference of
    :func:`_parallel_prefix_integrate`. Invalid or non-positive-dt steps
    hold the state. Returns ``(final, (Delta_R [S,3,3], Delta_p [S,3],
    dt_total [S]))``."""
    dev = dt.device
    R0 = torch.eye(3, dtype=_F32, device=dev) if R_world_body is None else R_world_body
    outs = []
    s = state
    for k in range(dt.shape[0]):
        ok = valid[k] & (dt[k] > 1e-9)
        dt_f = torch.where(ok, dt[k], 0.0)
        omega_mid = 0.5 * (omega0[k] + omega1[k]) - gyro_bias
        a_mid = 0.5 * (accel0[k] + accel1[k]) * params.accel_scale - accel_bias
        phi_mid = omega_mid * dt_f
        phi_half = omega_mid * (0.5 * dt_f)
        R_step, R_half = _rot(phi_mid), _rot(phi_half)
        Delta_R_mid = s.Delta_R @ R_half
        a_nav = Delta_R_mid @ a_mid
        Jr, Jr_half = right_jacobian_so3(phi_mid), right_jacobian_so3(phi_half)
        skew_a = lie.skew(a_mid)

        J_R_mid_bg = R_half.T @ s.J_R_bg - Jr_half * (0.5 * dt_f)
        DRSJ = Delta_R_mid @ skew_a @ J_R_mid_bg
        R_world_mid = R0 @ Delta_R_mid
        F = _transition(dt_f, R_world_mid, skew_a, R_half.T, -Jr_half * (0.5 * dt_f), R_step, Jr, (), dev)
        cov = F @ s.covariance @ F.T
        if params.has_noise():
            G = _noise_input(dt_f, R_world_mid, skew_a, Jr, Jr_half, (), dev)
            cov = cov + (G * _noise_density(params, dt_f)[None, :]) @ G.T
        cov = 0.5 * (cov + cov.T)
        new = PreintegrationState(
            Delta_R=s.Delta_R @ R_step,
            Delta_v=s.Delta_v + a_nav * dt_f,
            Delta_p=s.Delta_p + s.Delta_v * dt_f + 0.5 * a_nav * dt_f * dt_f,
            dt_total=s.dt_total + dt_f,
            J_R_bg=R_step.T @ s.J_R_bg - Jr * dt_f,
            J_v_bg=s.J_v_bg - DRSJ * dt_f,
            J_v_ba=s.J_v_ba - Delta_R_mid * dt_f,
            J_p_bg=s.J_p_bg + s.J_v_bg * dt_f - 0.5 * DRSJ * dt_f * dt_f,
            J_p_ba=s.J_p_ba + s.J_v_ba * dt_f - 0.5 * Delta_R_mid * dt_f * dt_f,
            covariance=cov,
        )
        s = PreintegrationState(*(torch.where(ok, n, o) for n, o in zip(new, s)))
        outs.append((s.Delta_R, s.Delta_p, s.dt_total))
    return s, tuple(torch.stack(x) for x in zip(*outs))


def inclusive_scan(elems: tuple, combine: Callable, dim: int = 0) -> tuple:
    """Inclusive scan along ``dim`` by recursive doubling (Hillis-Steele):
    ceil(log2 S) rounds, each one batched ``combine(earlier, later)`` over
    the shifted halves. ``combine`` must be associative."""
    S = elems[0].shape[dim]
    d = 1
    while d < S:
        new = combine(tuple(e.narrow(dim, 0, S - d) for e in elems), tuple(e.narrow(dim, d, S - d) for e in elems))
        elems = tuple(torch.cat([e.narrow(dim, 0, d), n], dim) for e, n in zip(elems, new))
        d *= 2
    return elems


def _compose_transitions(x, y):
    """(F, Q) of two steps in order: ``(F2 F1, F2 Q1 F2^T + Q2)``."""
    (F1, Q1), (F2, Q2) = x, y
    return F2 @ F1, F2 @ Q1 @ F2.transpose(-1, -2) + Q2


def _parallel_prefix_integrate(params: IMUPreintegrationParams, state: PreintegrationState, dt, omega0, omega1,
                               accel0, accel1, valid, gyro_bias, accel_bias, R_world_body=None):
    """The midpoint recurrence over prefix products, for B windows at once:
    ``dt [B, S]``, the readings ``[B, S, 3]``, each window with its own
    ``state`` (fields ``[B, ...]``), biases ``[B, 3]`` and ``R_world_body
    [B, 3, 3]``.

      * ``Delta_R``: an inclusive scan of the step rotations;
      * ``Delta_v`` / ``Delta_p``: cumsums of prefix-rotated midpoint terms;
      * bias Jacobians: ``J_k = M_k^T (J_0 + sum_{i<=k} M_i (-Jr_i dt_i))``
        (one cumsum), the v / p Jacobians cumsums of terms built from it;
      * covariance: an inclusive scan of ``(F, Q)`` pairs.

    Returns ``(final, (Delta_R [B,S,3,3], Delta_p [B,S,3], dt_total [B,S]))``.
    """
    dev = dt.device
    B, S = dt.shape
    eye3 = torch.eye(3, dtype=_F32, device=dev)
    R0w = eye3.expand(B, 3, 3) if R_world_body is None else R_world_body

    def excl(first, pref):  # the exclusive prefix: the window's start, then all but the last
        return torch.cat([first[:, None], pref[:, :-1]], 1)

    ok = valid & (dt > 1e-9)
    dt = torch.where(ok, dt, 0.0)
    dtv = dt[..., None]
    dtc = dt[..., None, None]
    omega_mid = 0.5 * (omega0 + omega1) - gyro_bias[:, None]
    a_mid = 0.5 * (accel0 + accel1) * params.accel_scale - accel_bias[:, None]
    phi_mid = omega_mid * dtv
    phi_half = 0.5 * phi_mid
    R_step, R_half = _rot(phi_mid), _rot(phi_half)  # I where dt = 0
    Jr, Jr_half = right_jacobian_so3(phi_mid), right_jacobian_so3(phi_half)
    skew_a = lie.skew(a_mid)

    # rotation prefixes: inclusive M_k = R_1 ... R_k, exclusive E_k
    (M,) = inclusive_scan((R_step,), lambda a, b: (a[0] @ b[0],), dim=1)
    E = excl(eye3.expand(B, 3, 3), M)
    E_full = state.Delta_R[:, None] @ E
    M_full = state.Delta_R[:, None] @ M
    DR_mid = E_full @ R_half  # Delta_R at the midpoint

    # velocity / position prefixes
    a_nav = (E_full @ (R_half @ (a_mid * dtv)[..., None]))[..., 0]
    v_pref = state.Delta_v[:, None] + torch.cumsum(a_nav, 1)
    p_pref = state.Delta_p[:, None] + torch.cumsum(excl(state.Delta_v, v_pref) * dtv + 0.5 * a_nav * dtv, 1)
    t_pref = state.dt_total[:, None] + torch.cumsum(dt, 1)

    # bias Jacobians; M_i (-Jr_i dt_i) = E_i R_step_i (-Jr_i) dt_i
    sum_R = state.J_R_bg[:, None] + torch.cumsum(E @ (R_step @ -Jr) * dtc, 1)
    J_R_bg = M.transpose(-1, -2) @ sum_R
    J_R_mid = R_half.transpose(-1, -2) @ excl(state.J_R_bg, J_R_bg) - Jr_half * (0.5 * dtc)
    DRSJ = DR_mid @ skew_a @ J_R_mid
    J_v_bg = state.J_v_bg[:, None] + torch.cumsum(-DRSJ * dtc, 1)
    J_v_ba = state.J_v_ba[:, None] + torch.cumsum(-DR_mid * dtc, 1)
    dt2 = dtc * dtc
    J_p_bg = state.J_p_bg[:, None] + torch.cumsum(excl(state.J_v_bg, J_v_bg) * dtc - 0.5 * DRSJ * dt2, 1)
    J_p_ba = state.J_p_ba[:, None] + torch.cumsum(excl(state.J_v_ba, J_v_ba) * dtc - 0.5 * DR_mid * dt2, 1)

    # covariance: (F, Q) pair scan; invalid steps are identity transitions
    R_world_mid = R0w[:, None] @ DR_mid
    F = _transition(dtc, R_world_mid, skew_a, R_half.transpose(-1, -2), -Jr_half * (0.5 * dtc), R_step, Jr,
                    (B, S), dev)
    F = torch.where(ok[..., None, None], F, torch.eye(15, dtype=_F32, device=dev))
    if params.has_noise():
        G = _noise_input(dtc, R_world_mid, skew_a, Jr, Jr_half, (B, S), dev)
        Q = (G * _noise_density(params, dt)[..., None, :]) @ G.transpose(-1, -2)
        Q = torch.where(ok[..., None, None], Q, 0.0)
    else:
        Q = torch.zeros((B, S, 15, 15), dtype=_F32, device=dev)
    F_prod, Q_acc = inclusive_scan((F, Q), _compose_transitions, dim=1)
    Fp, Qp = F_prod[:, -1], Q_acc[:, -1]
    cov = Fp @ state.covariance @ Fp.transpose(-1, -2) + Qp
    cov = 0.5 * (cov + cov.transpose(-1, -2))

    final = PreintegrationState(
        Delta_R=M_full[:, -1], Delta_v=v_pref[:, -1], Delta_p=p_pref[:, -1], dt_total=t_pref[:, -1],
        J_R_bg=J_R_bg[:, -1], J_v_bg=J_v_bg[:, -1], J_v_ba=J_v_ba[:, -1], J_p_bg=J_p_bg[:, -1],
        J_p_ba=J_p_ba[:, -1], covariance=cov,
    )
    return final, (M_full, p_pref, t_pref)


def integrate_steps(params, state, dt, omega0, omega1, accel0, accel1, valid, gyro_bias, accel_bias,
                    R_world_body=None, parallel: bool = True) -> PreintegrationState:
    """Integrate padded step arrays: one window (``dt [S]``) or B windows
    (``dt [B, S]``, every other input with the leading ``[B]``);
    ``parallel=False`` runs the sequential reference (one window)."""
    return integrate_steps_with_outputs(params, state, dt, omega0, omega1, accel0, accel1, valid, gyro_bias,
                                        accel_bias, R_world_body, parallel)[0]


def integrate_steps_with_outputs(params, state, dt, omega0, omega1, accel0, accel1, valid, gyro_bias, accel_bias,
                                 R_world_body=None, parallel: bool = True):
    """Like :func:`integrate_steps`, with the per-step cumulative
    ``(Delta_R [S,3,3], Delta_p [S,3], dt_total [S])``: the trajectory the
    IMU deskew samples."""
    args = (dt, omega0, omega1, accel0, accel1, valid, gyro_bias, accel_bias, R_world_body)
    if not parallel:
        return _integrate_scan(params, state, *args)
    if dt.dim() == 2:  # B windows
        return _parallel_prefix_integrate(params, state, *args)
    # one window: the stream form with one stream, so that a window and
    # stream b of B windows run the same kernels
    one = [None if a is None else a[None] for a in args]
    final, outs = _parallel_prefix_integrate(params, PreintegrationState(*(f[None] for f in state)), *one)
    return PreintegrationState(*(f[0] for f in final)), tuple(o[0] for o in outs)


def get_corrected(state: PreintegrationState, gyro_bias_lin, accel_bias_lin, gyro_bias_new,
                  accel_bias_new) -> PreintegrationState:
    """First-order bias correction."""
    d_bg = gyro_bias_new - gyro_bias_lin
    d_ba = accel_bias_new - accel_bias_lin
    R_corr = state.Delta_R @ _rot(state.J_R_bg @ d_bg)
    R_corr = lie.quat_to_matrix(lie.matrix_to_quat(R_corr))  # quaternion round trip renormalizes
    return state._replace(
        Delta_R=R_corr,
        Delta_v=state.Delta_v + state.J_v_bg @ d_bg + state.J_v_ba @ d_ba,
        Delta_p=state.Delta_p + state.J_p_bg @ d_bg + state.J_p_ba @ d_ba,
    )


_GRAVITY_CACHE: dict = {}


def gravity_vector(params: IMUPreintegrationParams, device: torch.device) -> torch.Tensor:
    """``params.gravity`` as a ``[3]`` tensor on ``device``, uploaded once."""
    key = (tuple(params.gravity), str(device))
    if key not in _GRAVITY_CACHE:
        _GRAVITY_CACHE[key] = torch.tensor(params.gravity, dtype=_F32, device=device)
    return _GRAVITY_CACHE[key]


def predict_transform(params: IMUPreintegrationParams, corrected: PreintegrationState, T_world_body_i,
                      v_world_i) -> torch.Tensor:
    """Absolute end-of-window pose ``[4, 4]``."""
    g = gravity_vector(params, corrected.dt_total.device)
    dt = corrected.dt_total
    R_i, p_i = T_world_body_i[:3, :3], T_world_body_i[:3, 3]
    p_j = p_i + v_world_i * dt + 0.5 * g * dt * dt + R_i @ corrected.Delta_p
    return lie.make_transform(R_i @ corrected.Delta_R, p_j)


def predict_relative_transform(params: IMUPreintegrationParams, corrected: PreintegrationState, R_world_body_i,
                               v_world_i) -> torch.Tensor:
    """Start-to-end transform ``[..., 4, 4]`` with gravity and
    initial-velocity compensation: the registration's initial guess (a
    leading ``[B]`` gives one a window)."""
    g = gravity_vector(params, corrected.dt_total.device)
    dt = corrected.dt_total[..., None]
    Rt = R_world_body_i.transpose(-1, -2)
    dp = corrected.Delta_p + 0.5 * matvec3(Rt, g) * dt * dt + matvec3(Rt, v_world_i) * dt
    return lie.make_transform(corrected.Delta_R, dp)


# ---------------------------------------------------------------------------
# host-side measurement windows (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IMUMeasurement:
    timestamp: float  # absolute wall time [s], float64
    gyro: np.ndarray  # [3] rad/s
    accel: np.ndarray  # [3] m/s^2


def interpolate_measurement(before: IMUMeasurement, after: IMUMeasurement, timestamp: float) -> IMUMeasurement:
    span = after.timestamp - before.timestamp
    if span <= 0.0:
        return before
    a = min(max((timestamp - before.timestamp) / span, 0.0), 1.0)
    return IMUMeasurement(
        timestamp=timestamp,
        gyro=((1 - a) * before.gyro + a * after.gyro).astype(np.float32),
        accel=((1 - a) * before.accel + a * after.accel).astype(np.float32),
    )


def build_measurement_window(measurements: Sequence[IMUMeasurement], start: float, end: float) -> list:
    """The measurements of ``[start, end]``, with samples interpolated at
    both ends."""
    window: list = []
    if end <= start:
        return window
    before_start = None
    for m in measurements:
        if m.timestamp <= start:
            before_start = m
            continue
        if m.timestamp > end:
            if not window and before_start is not None:
                window.append(interpolate_measurement(before_start, m, start))
            if window and window[-1].timestamp < end:
                window.append(interpolate_measurement(window[-1], m, end))
            break
        if not window and before_start is not None:
            window.append(
                interpolate_measurement(before_start, m, start)
                if before_start.timestamp < start
                else before_start
            )
        window.append(m)
    return window


def steps_from_window(window: Sequence[IMUMeasurement]):
    """Per-step ``(dt, omega0, omega1, accel0, accel1, valid)`` arrays of a
    window; non-increasing timestamps give invalid steps."""
    if len(window) < 2:
        z = np.zeros((1, 3), np.float32)
        return (np.zeros(1, np.float32), z, z, z, z, np.zeros(1, bool))
    ts = np.array([m.timestamp for m in window], np.float64)
    gyro = np.stack([m.gyro for m in window]).astype(np.float32)
    accel = np.stack([m.accel for m in window]).astype(np.float32)
    dt = np.diff(ts).astype(np.float32)
    valid = dt > 1e-9
    return dt, gyro[:-1], gyro[1:], accel[:-1], accel[1:], valid


def padded_steps_from_window(window: Sequence[IMUMeasurement], min_bucket: int = 32):
    """:func:`steps_from_window` padded with invalid steps to a power-of-two
    bucket of at least ``min_bucket``."""
    dt, w0, w1, a0, a1, valid = steps_from_window(window)
    S = len(dt)
    Sp = max(min_bucket, 1 << (max(S, 1) - 1).bit_length())
    if Sp != S:
        pad = Sp - S
        z = np.zeros((pad, 3), np.float32)
        dt = np.concatenate([dt, np.zeros(pad, np.float32)])
        w0, w1 = np.concatenate([w0, z]), np.concatenate([w1, z])
        a0, a1 = np.concatenate([a0, z]), np.concatenate([a1, z])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return dt, w0, w1, a0, a1, valid


def pack_steps(dt, w0, w1, a0, a1, valid) -> np.ndarray:
    """The per-step arrays as one ``[S, 14]`` float32 array
    (dt | w0 | w1 | a0 | a1 | valid): one host-to-device copy a window."""
    return np.concatenate(
        [
            np.asarray(dt, np.float32)[:, None],
            np.asarray(w0, np.float32),
            np.asarray(w1, np.float32),
            np.asarray(a0, np.float32),
            np.asarray(a1, np.float32),
            np.asarray(valid, np.float32)[:, None],
        ],
        axis=1,
    )


def unpack_steps(packed):
    """Inverse of :func:`pack_steps` (numpy or a tensor; ``[S, 14]``, or
    B windows ``[B, S, 14]``)."""
    return (packed[..., 0], packed[..., 1:4], packed[..., 4:7], packed[..., 7:10], packed[..., 10:13],
            packed[..., 13] > 0.5)


class IMUPreintegration:
    """Streaming wrapper: buffer measurements on the host, integrate the
    window on ``device`` (the card unless the caller asks for the CPU) when
    a result is asked for."""

    def __init__(self, params: IMUPreintegrationParams = IMUPreintegrationParams(),
                 device: torch.device | str = "cuda"):
        self.params = params
        self.device = require_device(device)
        self.reset()

    def reset(self, gyro_bias=None, accel_bias=None, initial_covariance=None, R_world_body=None):
        self.gyro_bias = np.zeros(3, np.float32) if gyro_bias is None else np.asarray(gyro_bias, np.float32)
        self.accel_bias = np.zeros(3, np.float32) if accel_bias is None else np.asarray(accel_bias, np.float32)
        self.R_world_body = (
            np.eye(3, dtype=np.float32) if R_world_body is None else np.asarray(R_world_body, np.float32)
        )
        self._init_cov = initial_covariance
        self._measurements: list = []
        self._state: Optional[PreintegrationState] = None

    def integrate(self, meas: IMUMeasurement):
        if self._measurements and meas.timestamp <= self._measurements[-1].timestamp:
            return
        self._measurements.append(meas)
        self._state = None

    def integrate_batch(self, measurements: Sequence[IMUMeasurement]):
        for m in measurements:
            self.integrate(m)

    @property
    def num_measurements(self) -> int:
        return len(self._measurements)

    def has_measurements(self) -> bool:
        return len(self._measurements) > 0

    def get_raw(self) -> PreintegrationState:
        if self._state is None:
            cov = np.zeros((15, 15), np.float32) if self._init_cov is None else self._init_cov
            packed, gb, ab, R, P0 = to_device(self.device, 
                pack_steps(*padded_steps_from_window(self._measurements)),
                self.gyro_bias, self.accel_bias, self.R_world_body, cov)
            self._state = integrate_steps(self.params, init_state(P0), *unpack_steps(packed), gb, ab, R)
        return self._state

    def get_corrected(self, gyro_bias, accel_bias) -> PreintegrationState:
        raw = self.get_raw()
        return get_corrected(raw, *to_device(self.device, self.gyro_bias, self.accel_bias, gyro_bias, accel_bias))

    def get_dt_total(self) -> float:
        return to_host(self.get_raw().dt_total)

    def predict_transform(self, T_world_body_i, v_world_i, gyro_bias=None, accel_bias=None):
        c = self._corrected_or_raw(gyro_bias, accel_bias)
        return predict_transform(self.params, c, *to_device(self.device, T_world_body_i, v_world_i))

    def predict_relative_transform(self, R_world_body_i, v_world_i, gyro_bias=None, accel_bias=None):
        c = self._corrected_or_raw(gyro_bias, accel_bias)
        return predict_relative_transform(self.params, c, *to_device(self.device, R_world_body_i, v_world_i))

    def _corrected_or_raw(self, gyro_bias, accel_bias):
        if gyro_bias is None and accel_bias is None:
            return self.get_raw()
        gb = self.gyro_bias if gyro_bias is None else gyro_bias
        ab = self.accel_bias if accel_bias is None else accel_bias
        return self.get_corrected(gb, ab)
