"""The port's KITTI runner and its sensor-message conversion, on the CPU.

  * ``read_kitti_bin`` equal to the JAX module's, array for array;
  * ``write_tum`` byte-equal to the JAX module's on the same poses;
  * ``main`` over 3 synthetic ``.bin`` scans (the world of
    ``tests/test_conversion_apps.py``: the sensor moves 0.2 m a frame along
    x), synchronous and ``--pipelined``, with the runner's scan parameters
    on a smaller map (the CPU's plain k-NN scans every target row): a TUM
    line a frame at the 10 Hz stamps, the last within 0.1 m of 0.4 m (the JAX
    test asks 0.1-0.7 m), the two runs within 0.02 m of each other.
"""

import numpy as np
import pytest

from sycl_points_tpu.apps import kitti_odometry as j_kitti
from sycl_points_tpu.points import conversion as j_conv
from sycl_points_tpu_torch.apps import kitti_odometry as t_kitti
from sycl_points_tpu_torch.points import conversion as t_conv

N_FRAMES = 3
CONFIG = """
scan:
  downsampling:
    voxel: {enable: true, size: 1.0}
    polar: {enable: false}
    random: {enable: true, num: 5000}
submap:
  map_capacity: 4096
  extract_capacity: 2048
"""


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    rng = np.random.default_rng(42)
    world = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    world[:, 2] *= 0.2
    vel = tmp_path_factory.mktemp("seq") / "velodyne"
    vel.mkdir()
    for i in range(N_FRAMES):
        pts = world - np.array([0.2 * i, 0, 0], np.float32)
        raw = np.concatenate([pts, rng.uniform(size=(len(pts), 1)).astype(np.float32)], 1)
        raw.tofile(vel / f"{i:06d}.bin")
    config = vel.parent / "params.yaml"
    config.write_text(CONFIG)
    return vel, config


def test_read_kitti_bin_equals_the_original(sequence):
    vel, _ = sequence
    path = str(vel / "000001.bin")
    ours, theirs = t_conv.read_kitti_bin(path), j_conv.read_kitti_bin(path)
    assert sorted(ours) == sorted(theirs) == ["intensities", "points"]
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_write_tum_equals_the_original(tmp_path):
    rng = np.random.default_rng(3)
    poses = []
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.normal(size=3) * 10
        poses.append(T)
    stamps = [0.1 * i for i in range(4)]
    t_kitti.write_tum(str(tmp_path / "a.tum"), stamps, poses)
    j_kitti.write_tum(str(tmp_path / "b.tum"), stamps, poses)
    assert (tmp_path / "a.tum").read_bytes() == (tmp_path / "b.tum").read_bytes()


def test_main_runs_the_sequence(sequence, tmp_path):
    vel, config = sequence
    trajs = {}
    for name, extra in (("sync", []), ("pipelined", ["--pipelined"])):
        out = tmp_path / f"{name}.tum"
        assert t_kitti.main([str(vel), "--out", str(out), "--config", str(config), "--device", "cpu", *extra]) == 0
        trajs[name] = np.loadtxt(out)
        assert trajs[name].shape == (N_FRAMES, 8)
        np.testing.assert_allclose(trajs[name][:, 0], 0.1 * np.arange(N_FRAMES))
        assert abs(trajs[name][-1, 1] - 0.2 * (N_FRAMES - 1)) < 0.1
    np.testing.assert_allclose(trajs["pipelined"][:, 1:4], trajs["sync"][:, 1:4], atol=0.02)


def test_main_refuses_an_empty_directory(tmp_path):
    assert t_kitti.main([str(tmp_path), "--device", "cpu"]) == 1
