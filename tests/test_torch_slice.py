"""The port's scan-pair slice as a whole against the JAX package.

  * preprocess + align_pipeline on a 512 x 32 synthetic pair raycast by
    ``World.raycast``, the same points into both packages, the port's
    sampling fed JAX's own Gumbel scores: final poses within 2 mm and 0.1 deg
    of each other, both within 2 cm of the ground truth;
  * ``register_pair`` with its own generator: within 2 cm and 0.5 deg of the
    ground truth;
  * ``utils.synthetic.raycast`` against ``World.raycast``: same sky rays,
    distances within atol=1e-4;
  * ``convert.params_from_reference`` on the benchmark's parameters;
  * importing every module of the port leaves jax out of ``sys.modules``.
"""

import dataclasses
import enum
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
from synthetic_velodyne import World, figure8_trajectory, hdl64_dirs, scan_at  # noqa: E402

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals  # noqa: E402
from sycl_points_tpu.ops.filters import box_filter  # noqa: E402
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, approx_knn  # noqa: E402
from sycl_points_tpu.ops.robust import RobustLossType  # noqa: E402
from sycl_points_tpu.ops.voxel import voxel_downsample  # noqa: E402
from sycl_points_tpu.registration.factors import RegType  # noqa: E402
from sycl_points_tpu.registration.pipeline import (  # noqa: E402
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    align_pipeline,
)
from sycl_points_tpu.registration.registration import RegistrationParams, RobustParams  # noqa: E402
from sycl_points_tpu_torch.apps import example_registration as app  # noqa: E402
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference  # noqa: E402
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN  # noqa: E402
from sycl_points_tpu_torch.registration import pipeline as t_pipeline  # noqa: E402
from sycl_points_tpu_torch.utils import synthetic  # noqa: E402

VOXEL, K = 0.25, 10


def bench_params():
    """The benchmark's registration parameters (bench.py:65-78)."""
    return RegistrationPipelineParams(
        registration=RegistrationParams(
            reg_type=RegType.GICP,
            robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE),
            optimization_method="levenberg_marquardt",
            max_iterations=10,
        ),
        random_sampling=RandomSamplingParams(enable=True, num=1000),
        robust=RobustScheduleParams(
            auto_scale=True, init_scale=10.0, min_scale=2.5,
            rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=3,
        ),
    )


def _jax_preprocess(cloud, cap):
    c = voxel_downsample(box_filter(cloud, 0.5, 50.0), VOXEL, out_capacity=cap)
    knn = approx_knn(c.points, c.mask, c.points, K)
    covs = estimate_covariances(c.points, knn)
    return c.replace(covs=covs, normals=extract_normals(c.points, covs))


@pytest.fixture(scope="module")
def scan_pair():
    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    src = scan_at(world, pose_src, n_az=512, n_rings=32)
    tgt = scan_at(world, pose_tgt, n_az=512, n_rings=32)
    return src, tgt, np.linalg.inv(pose_tgt) @ pose_src


def test_slice_matches_jax(scan_pair):
    src, tgt, T_gt = scan_pair
    (js_raw, ts_raw), (jt_raw, tt_raw) = clouds(src), clouds(tgt)
    cap = app.voxel_capacity((ts_raw, tt_raw), VOXEL)
    params = bench_params()

    js, jt = _jax_preprocess(js_raw, cap), _jax_preprocess(jt_raw, cap)
    key = jax.random.key(1234)
    jout = align_pipeline(js, jt, JBruteForceKNN.build(jt), params, key=key)

    ts, tt = app.preprocess(ts_raw, VOXEL, K, cap), app.preprocess(tt_raw, VOXEL, K, cap)
    np.testing.assert_array_equal(np_(ts.mask), np_(js.mask))
    scores = both(np_(jax.random.gumbel(key, (cap,))))[1]
    tout = t_pipeline.align_pipeline(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params), scores=scores)

    Tj, Tt = np_(jout.result.T).astype(np.float64), np_(tout.result.T).astype(np.float64)
    trans, rot = app.pose_error(Tt, Tj)
    assert trans <= 2e-3 and rot <= 0.1, (trans, rot)
    for T in (Tj, Tt):
        trans, _ = app.pose_error(T, T_gt)
        assert trans <= 0.02, trans


def test_register_pair_recovers_ground_truth(scan_pair):
    src, tgt, T_gt = scan_pair
    res = app.register_pair(
        cloud_from_numpy(src, device="cpu"), cloud_from_numpy(tgt, device="cpu"), VOXEL, K,
        generator=torch.Generator().manual_seed(1234),
    )
    trans, rot = app.pose_error(np_(res.output.result.T), T_gt)
    assert trans <= 0.02 and rot <= 0.5, (trans, rot)
    assert int(res.output.registration_input.count()) == 1000
    assert float(t_pipeline.inlier_ratio(res.output)) > 0.9


@pytest.mark.parametrize("per_ray_origin", [False, True])
def test_raycast_matches_world_raycast(per_ray_origin):
    world = World()
    T = figure8_trajectory(5, speed=0.7)[4]
    dirs = hdl64_dirs(512, 32, seed=3) @ T[:3, :3].T.astype(np.float32)
    origin = T[:3, 3]
    if per_ray_origin:
        origin = origin + np.random.default_rng(0).normal(scale=0.3, size=(len(dirs), 3))
    ref = world.raycast(origin, dirs.astype(np.float64))
    out = np_(synthetic.raycast(world, origin, torch.from_numpy(dirs)))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=1e-4)


def test_synthetic_scan_at_matches_reference():
    world = World()
    T = figure8_trajectory(3, speed=0.7)[2]
    ref = scan_at(world, T, n_az=128, n_rings=16)
    out = synthetic.scan_at(world, T, n_az=128, n_rings=16, device="cpu")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def _as_plain(obj):
    """Nested plain values with enums by name, for comparing the packages."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _as_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def test_params_from_reference_round_trips():
    ref = bench_params()
    port = params_from_reference(ref)
    assert type(port) is t_pipeline.RegistrationPipelineParams
    assert _as_plain(port) == _as_plain(ref)
    assert port == app.PAIR_PARAMS


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sycl_points_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_example_registration_cli(tmp_path, capsys):
    from sycl_points_tpu.points import io

    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    paths = []
    for name, pose in (("source", pose_src), ("target", pose_tgt)):
        path = tmp_path / f"{name}.ply"
        io.write_ply(str(path), {"points": scan_at(world, pose, n_az=256, n_rings=24)})
        paths.append(str(path))
    gt = tmp_path / "gt.txt"
    np.savetxt(gt, np.linalg.inv(pose_tgt) @ pose_src)
    rc = app.main(paths + ["--voxel", "0.5", "--loops", "1", "--warmup", "0", "--device", "cpu", "--gt", str(gt)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "7. Registration" in out and "vs ground truth: translation" in out
    trans_cm = float(out.split("vs ground truth: translation ")[1].split(" cm")[0])
    assert trans_cm < 5.0


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: exit != 0 and no result line, in the repo and alone."""
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
