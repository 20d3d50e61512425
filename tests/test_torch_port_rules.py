"""The port stands on its own and runs on the card unless asked for the CPU.

  * no module of ``sycl_points_tpu_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``sycl_points_tpu``, ``scripts`` or ``benchmarks`` (an ``ast``
    walk over the sources);
  * the port's own copies equal the originals exactly: the PLY/PCD readers
    on files written by ``sycl_points_tpu.points.io`` (ascii, binary,
    big-endian PLY, binary_compressed PCD), ``finite_filter``, and
    ``World``, ``hdl64_dirs``, ``figure8_trajectory``, ``figure8_velocity``,
    ``figure8_imu``, ``figure8_imu_3d`` of
    ``benchmarks/synthetic_velodyne.py`` (``scan_at_distorted``, raycast in
    float32, in ``tests/test_torch_deskew.py``; the IMU copies in
    ``tests/test_torch_imu.py``);
  * the writers (PLY ascii / binary, PCD ascii / binary /
    binary_compressed) write the originals' bytes, and the pure-Python LZF
    compressor gives the original's stream (the rest of the new copies,
    native_io, prefix_sum, the filters, FPS, the facade, timing, profiling
    and the covariance markers, in ``tests/test_torch_filters_io.py``);
  * ``points/conversion.py`` and ``apps/stream_protocol.py`` equal their
    originals: the same constants, and the same outputs (arrays and bytes)
    on PointCloud2 buffers with every field kind, unaligned offsets, and
    every message type; ``EnhancedReflectivityCorrector`` over two scans;
  * the entry points default to ``"cuda"`` and raise without a card, the
    fleet's among them (``parallel.fleet.FleetOdometry`` and ``FleetLIO``,
    at the parameter tree's defaults too, ``apps.fleet_odometry.run_fleet``
    and ``main``, ``apps.fleet_replay``'s LIO runs,
    ``convert.carry_from_reference`` and ``fleet_lio_state_from_reference``),
    ``PreprocessFilter``, ``LidarOdometry`` with the raw-features
    covariances, and ``parallel.sharded.make_mesh`` (the visible cards);
  * ``apps.fleet_replay``'s copy of the JAX fleet benchmark's ``--lio``
    deployment (``benchmarks/bench_fleet.py:112-200``) equals it: the
    parameter tree, the IMU feed (every reading, both ends of each chunk)
    and each stream's initial velocity; ``default_trees`` gives the tree's
    default ``scan`` and ``submap``.
"""

import ast
import dataclasses
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402

from sycl_points_tpu.apps import stream_protocol as ref_sp  # noqa: E402
from sycl_points_tpu.points import conversion as ref_conv  # noqa: E402
from sycl_points_tpu.points import io as ref_io  # noqa: E402
from sycl_points_tpu_torch.apps import example_registration, kitti_odometry, lio_replay, odometry_replay  # noqa: E402
from sycl_points_tpu_torch.apps import fleet_odometry, fleet_replay, stream_odometry  # noqa: E402
from sycl_points_tpu_torch.apps import stream_protocol as port_sp  # noqa: E402
from sycl_points_tpu_torch.convert import (  # noqa: E402
    carry_from_reference,
    cloud_from_numpy,
    fleet_lio_state_from_reference,
    lio_state_from_reference,
    map_state_from_reference,
    params_from_reference,
)
from sycl_points_tpu_torch.imu import factor as imu_factor  # noqa: E402
from sycl_points_tpu_torch.imu import preintegration  # noqa: E402
from sycl_points_tpu_torch.mapping import voxel_hash_map  # noqa: E402
from sycl_points_tpu_torch.ops.preprocess_filter import PreprocessFilter  # noqa: E402
from sycl_points_tpu_torch.parallel import sharded  # noqa: E402
from sycl_points_tpu_torch.parallel.fleet import FleetLIO, FleetOdometry  # noqa: E402
from sycl_points_tpu_torch.pipeline import params as lo_params  # noqa: E402
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry  # noqa: E402
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry  # noqa: E402
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor  # noqa: E402
from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry  # noqa: E402
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry  # noqa: E402
from sycl_points_tpu_torch.pipeline.submap import Submap  # noqa: E402
from sycl_points_tpu_torch.points import conversion as port_conv  # noqa: E402
from sycl_points_tpu_torch.points import io as port_io  # noqa: E402
from sycl_points_tpu_torch.points.point_cloud import PointCloud  # noqa: E402
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants  # noqa: E402
from sycl_points_tpu_torch.utils import synthetic  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "sycl_points_tpu", "scripts", "benchmarks"}


def forbidden_imports(source: str) -> list:
    """Top-level packages of ``source``'s imports that the port may not use."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_nothing_of_the_jax_side():
    files = sorted((ROOT / "sycl_points_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    walked = {str(f.relative_to(ROOT)) for f in files}
    assert {"sycl_points_tpu_torch/registration/degenerate.py",
            "sycl_points_tpu_torch/registration/rotation_constraint.py",
            "sycl_points_tpu_torch/ops/range_image_knn.py", "sycl_points_tpu_torch/ops/prefix_sum.py",
            "sycl_points_tpu_torch/ops/preprocess_filter.py", "sycl_points_tpu_torch/points/native_io.py",
            "sycl_points_tpu_torch/utils/timing.py", "sycl_points_tpu_torch/utils/profiling.py",
            "sycl_points_tpu_torch/apps/covariance_markers.py", "sycl_points_tpu_torch/ops/grid_knn.py",
            "sycl_points_tpu_torch/ops/coarse_knn.py", "sycl_points_tpu_torch/ops/window_knn.py",
            "sycl_points_tpu_torch/ops/pair_preprocess.py", "sycl_points_tpu_torch/parallel/sharded.py",
            "sycl_points_tpu_torch/utils/device.py"} <= walked
    bad = {str(f.relative_to(ROOT)): forbidden_imports(f.read_text()) for f in files}
    assert not {f: b for f, b in bad.items() if b}


@pytest.mark.parametrize("source,found", [
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from sycl_points_tpu.points import io", ["sycl_points_tpu.points"]),
    ("def f():\n    from benchmarks.synthetic_velodyne import World", ["benchmarks.synthetic_velodyne"]),
    ("import scripts.bench_nn1_variants", ["scripts.bench_nn1_variants"]),
    ("from sycl_points_tpu_torch.points import io\nfrom . import x", []),
])
def test_forbidden_imports_finds_them(source, found):
    assert forbidden_imports(source) == found


def _cloud(n=257, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    return {
        "points": rng.uniform(-50, 50, (n, 3)).astype(np.float32),
        "normals": (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32),
        "rgb": np.concatenate([rng.uniform(0, 1, (n, 3)), np.ones((n, 1))], 1).astype(np.float32),
        "intensities": rng.uniform(0, 255, n).astype(np.float32),
    }


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,write", [
    ("ascii.ply", lambda p, c: ref_io.write_ply(p, c, binary=False)),
    ("binary.ply", lambda p, c: ref_io.write_ply(p, c, binary=True)),
    ("ascii.pcd", lambda p, c: ref_io.write_pcd(p, c, binary=False)),
    ("binary.pcd", lambda p, c: ref_io.write_pcd(p, c, binary=True)),
    ("compressed.pcd", lambda p, c: ref_io.write_pcd(p, c, compressed=True)),
])
def test_readers_equal_the_originals(tmp_path, name, write):
    path = str(tmp_path / name)
    write(path, _cloud())
    _assert_same(port_io.read_file(path), ref_io.read_file(path))


def test_big_endian_ply_equals_the_original(tmp_path):
    pts = _cloud(33)["points"]
    path = tmp_path / "be.ply"
    header = "ply\nformat binary_big_endian 1.0\nelement vertex 33\n" + "".join(
        f"property float {c}\n" for c in "xyz") + "end_header\n"
    path.write_bytes(header.encode() + pts.astype(">f4").tobytes())
    out = port_io.read_ply(str(path))
    _assert_same(out, ref_io.read_ply(str(path)))
    np.testing.assert_array_equal(out["points"], pts)


@pytest.mark.parametrize("name,write", [
    ("ascii.ply", lambda io, p, c: io.write_ply(p, c, binary=False)),
    ("binary.ply", lambda io, p, c: io.write_ply(p, c, binary=True)),
    ("ascii.pcd", lambda io, p, c: io.write_pcd(p, c, binary=False)),
    ("binary.pcd", lambda io, p, c: io.write_pcd(p, c, binary=True)),
    ("compressed.pcd", lambda io, p, c: io.write_pcd(p, c, compressed=True)),
])
def test_writers_equal_the_originals(tmp_path, name, write):
    """The port's writers write the originals' bytes, and the pure-Python
    LZF compressor gives the original's stream."""
    ours, theirs = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    write(port_io, ours, _cloud())
    write(ref_io, theirs, _cloud())
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    soa = np.ascontiguousarray(_cloud()["points"].T).tobytes()
    assert port_io._lzf_compress_py(soa) == ref_io._lzf_compress_py(soa)


def test_reflectivity_corrector_equals_the_original():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.5, 20, (300, 3)).astype(np.float32)
    args = (rng.uniform(0, 1, 300).astype(np.float32), rng.integers(0, 300, 300).astype(np.uint16),
            rng.uniform(0, 50, 300).astype(np.float32))
    assert port_conv.EnhancedReflectivityCorrector.MAX_RINGS == ref_conv.EnhancedReflectivityCorrector.MAX_RINGS
    ours, theirs = port_conv.EnhancedReflectivityCorrector(0.3), ref_conv.EnhancedReflectivityCorrector(0.3)
    for _ in range(2):
        np.testing.assert_array_equal(ours.apply(pts, *args), theirs.apply(pts, *args))


def test_finite_filter_equals_the_original():
    cloud = _cloud(50, seed=1)
    cloud["points"][::7] = np.nan
    cloud["points"][3, 1] = np.inf
    _assert_same(port_io.finite_filter(cloud), ref_io._finite_filter(cloud))


def _pc2_cloud(n=37, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "points": rng.normal(size=(n, 3)).astype(np.float32),
        "intensities": rng.uniform(0, 255, n).astype(np.float32),
        "timestamp_offsets": np.linspace(0, 95, n).astype(np.float32),
        "rgb": np.concatenate([rng.uniform(size=(n, 3)), np.ones((n, 1))], 1).astype(np.float32),
    }


@pytest.mark.parametrize("keys", [("points",), ("points", "intensities"), ("points", "timestamp_offsets"),
                                  ("points", "intensities", "timestamp_offsets", "rgb")])
def test_pointcloud2_packing_equals_the_original(keys):
    cloud = {k: v for k, v in _pc2_cloud().items() if k in keys}
    np.testing.assert_array_equal(port_conv.to_structured_array(cloud), ref_conv.to_structured_array(cloud))
    ours, theirs = port_conv.to_pointcloud2_bytes(cloud), ref_conv.to_pointcloud2_bytes(cloud)
    assert ours == theirs
    _assert_same(port_conv.from_pointcloud2_bytes(*ours), ref_conv.from_pointcloud2_bytes(*theirs))


@pytest.mark.parametrize("time_field,scale", [("t", 1e-3), ("time", 1.0), ("timestamp", 1e6), ("time_offset", 1.0)])
def test_pointcloud2_parsing_equals_the_original(time_field, scale):
    """Unaligned offsets, packed rgba, ring, ambient, every time unit."""
    n = 29
    rng = np.random.default_rng(7)
    rec = np.zeros(n, np.dtype({"names": ["x", "y", "z", "reflectivity", "rgba", time_field, "ring", "ambient"],
                                "formats": [np.float32] * 4 + [np.uint32, np.float64, np.uint16, np.uint16],
                                "offsets": [0, 4, 8, 13, 17, 21, 29, 31], "itemsize": 34}))
    for c in "xyz":
        rec[c] = rng.normal(size=n)
    rec["reflectivity"] = rng.uniform(0, 100, n)
    rec["rgba"] = rng.integers(0, 2**24, n)
    rec[time_field] = (1e3 + np.arange(n)) * scale
    rec["ring"] = rng.integers(0, 64, n)
    rec["ambient"] = rng.integers(0, 500, n)
    fields = [(name, rec.dtype.fields[name][1], code) for name, code in zip(
        rec.dtype.names, (7, 7, 7, 7, 6, 8, 4, 4))]
    _assert_same(port_conv.from_pointcloud2_bytes(rec.tobytes(), fields, 34),
                 ref_conv.from_pointcloud2_bytes(rec.tobytes(), fields, 34))


def test_read_kitti_bin_equals_the_original(tmp_path):
    raw = np.random.default_rng(1).normal(size=(101, 4)).astype(np.float32)
    raw.tofile(tmp_path / "000000.bin")
    _assert_same(port_conv.read_kitti_bin(str(tmp_path / "000000.bin")),
                 ref_conv.read_kitti_bin(str(tmp_path / "000000.bin")))


def test_stream_protocol_equals_the_original():
    for name in ("MAGIC", "HEADER_SIZE", "MSG_POINTCLOUD", "MSG_IMU", "MSG_POSE", "MSG_MAP", "MSG_STATUS", "MSG_BYE",
                 "FLAG_WANT_MAP", "DATATYPE_OF"):
        assert getattr(port_sp, name) == getattr(ref_sp, name), name
    cloud = _pc2_cloud()
    payloads = {
        port_sp.MSG_POINTCLOUD: (port_sp.cloud_to_payload(cloud), ref_sp.cloud_to_payload(cloud)),
        port_sp.MSG_IMU: (port_sp.encode_imu_payload([0.1, -0.2, 0.3], [0.0, 0.5, 9.81]),
                          ref_sp.encode_imu_payload([0.1, -0.2, 0.3], [0.0, 0.5, 9.81])),
        port_sp.MSG_POSE: (port_sp.encode_pose_payload(9, 6, 0.75, [1, 2, 3], [0, 0, 0.6, 0.8]),
                           ref_sp.encode_pose_payload(9, 6, 0.75, [1, 2, 3], [0, 0, 0.6, 0.8])),
        port_sp.MSG_STATUS: (port_sp.encode_status_payload({"a": [1, 2.5]}),
                             ref_sp.encode_status_payload({"a": [1, 2.5]})),
        port_sp.MSG_BYE: (b"", b""),
    }
    for msg_type, (ours, theirs) in payloads.items():
        assert ours == theirs, msg_type
        raw = port_sp.encode(port_sp.Message(msg_type=msg_type, seq=3, timestamp=1.25, payload=ours, flags=1))
        assert raw == ref_sp.encode(ref_sp.Message(msg_type=msg_type, seq=3, timestamp=1.25, payload=theirs, flags=1))
        assert port_sp.decode_header(raw[:port_sp.HEADER_SIZE]) == ref_sp.decode_header(raw[:ref_sp.HEADER_SIZE])
    _assert_same(port_sp.payload_to_cloud(payloads[port_sp.MSG_POINTCLOUD][0]),
                 ref_sp.payload_to_cloud(payloads[port_sp.MSG_POINTCLOUD][1]))
    pose = payloads[port_sp.MSG_POSE][0]
    for a, b in zip(port_sp.decode_pose_payload(pose), ref_sp.decode_pose_payload(pose), strict=True):
        np.testing.assert_array_equal(a, b)
    imu = payloads[port_sp.MSG_IMU][0]
    for a, b in zip(port_sp.decode_imu_payload(imu), ref_sp.decode_imu_payload(imu), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [{}, {"seed": 3, "n_boxes": 60}, {"seed": 5, "hard": True}])
def test_world_equals_the_original(kwargs):
    ours, theirs = synthetic.World(**kwargs), ref_synth.World(**kwargs)
    assert ours.wall_r == theirs.wall_r
    np.testing.assert_array_equal(ours.box_lo, theirs.box_lo)
    np.testing.assert_array_equal(ours.box_hi, theirs.box_hi)


def test_rays_and_trajectory_equal_the_originals():
    for args in ((), (256, 16, 2)):
        np.testing.assert_array_equal(synthetic.hdl64_dirs(*args), ref_synth.hdl64_dirs(*args))
    for kwargs in ({"speed": 0.7}, {"excite3d": True}, {"radius": 12.0}):
        for a, b in zip(synthetic.figure8_trajectory(9, **kwargs), ref_synth.figure8_trajectory(9, **kwargs),
                        strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.3, 7.9])
def test_imu_and_velocity_equal_the_originals(t):
    for kwargs in ({}, {"speed": 0.7}, {"radius": 12.0}):
        for ours, theirs in ((synthetic.figure8_imu, ref_synth.figure8_imu),
                             (synthetic.figure8_imu_3d, ref_synth.figure8_imu_3d)):
            for a, b in zip(ours(t, **kwargs), theirs(t, **kwargs), strict=True):
                np.testing.assert_array_equal(a, b)
        for excite3d in (False, True):
            np.testing.assert_array_equal(synthetic.figure8_velocity(t, excite3d=excite3d, **kwargs),
                                          ref_synth.figure8_velocity(t, excite3d=excite3d, **kwargs))


@pytest.mark.parametrize("fn", [cloud_from_numpy, PointCloud.from_numpy, synthetic.scan_at,
                                bench_nn1_tiles.main, bench_nn1_variants.main,
                                LidarOdometry, Submap, PCProcessor, voxel_hash_map.create,
                                map_state_from_reference, synthetic.scan_at_distorted, LidarInertialOdometry,
                                lio_replay.make_lio_inputs, lio_replay.run_lio_replay, lio_state_from_reference,
                                preintegration.IMUPreintegration, preintegration.init_state,
                                imu_factor.State.identity, PipelinedLidarOdometry, PipelinedLidarInertialOdometry,
                                stream_odometry.OdometryStreamServer, odometry_replay.run_pipelined_replay,
                                lio_replay.run_pipelined_lio_replay, FleetOdometry, fleet_odometry.run_fleet,
                                carry_from_reference, FleetLIO, fleet_replay.run_fleet_lio_replay,
                                fleet_replay.run_stream_lio_replay, fleet_lio_state_from_reference,
                                PreprocessFilter])
def test_device_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        example_registration.main(["source.ply", "target.ply"])
    with pytest.raises(RuntimeError, match="is_available"):
        cloud_from_numpy(pts)
    with pytest.raises(RuntimeError, match="is_available"):
        synthetic.scan_at(synthetic.World(), np.eye(4), n_az=8, n_rings=2)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_nn1_variants.main(shapes=((4, 8),))
    with pytest.raises(RuntimeError, match="is_available"):
        kitti_odometry.main(["velodyne"])
    with pytest.raises(RuntimeError, match="is_available"):
        stream_odometry.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="is_available"):
        fleet_odometry.run_fleet([["scan.bin"]], _vhm_params(), "fleet")
    with pytest.raises(RuntimeError, match="is_available"):
        sharded.make_mesh(1)
    assert cloud_from_numpy(pts, device="cpu").device.type == "cpu"


def _vhm_params():
    """A parameter tree of what is ported: voxel-hash map, no polar stage."""
    return lo_params.LidarOdometryParams(
        scan=lo_params.ScanParams(downsampling=lo_params.DownsamplingParams(
            polar=lo_params.PolarDownsamplingParams(enable=False))),
        submap=lo_params.SubmapParams(map_type="VOXEL_HASH_MAP", map_capacity=1 << 8, extract_capacity=1 << 6),
    )


@pytest.mark.parametrize("make", [
    lambda **kw: LidarOdometry(_vhm_params(), **kw),
    lambda **kw: Submap(_vhm_params(), **kw),
    lambda **kw: PCProcessor(_vhm_params(), **kw),
    lambda **kw: voxel_hash_map.create(voxel_hash_map.VoxelHashMapConfig(capacity=1 << 8), **kw),
    lambda **kw: map_state_from_reference(
        voxel_hash_map.create(voxel_hash_map.VoxelHashMapConfig(capacity=1 << 8), device="cpu"), **kw),
    lambda **kw: LidarInertialOdometry(_lio_params(), **kw),
    lambda **kw: lio_replay.make_lio_inputs(2, 16, 4, **kw),
    lambda **kw: lio_replay.run_lio_replay(_lio_params(), lio_replay.make_lio_inputs(1, 16, 4, device="cpu"), **kw),
    lambda **kw: lio_state_from_reference(imu_factor.State.identity(device="cpu"), np.eye(15), **kw),
    lambda **kw: preintegration.IMUPreintegration(**kw),
    lambda **kw: preintegration.init_state(**kw),
    lambda **kw: imu_factor.State.identity(**kw),
    lambda **kw: synthetic.scan_at_distorted(synthetic.World(), np.eye(4), np.eye(4), n_az=8, n_rings=2, **kw),
    lambda **kw: PipelinedLidarOdometry(_vhm_params(), **kw),
    lambda **kw: PipelinedLidarInertialOdometry(_lio_params(), **kw),
    lambda **kw: stream_odometry.OdometryStreamServer(_vhm_params(), **kw),
    lambda **kw: FleetOdometry(_vhm_params(), n_streams=2, **kw),
    lambda **kw: FleetOdometry(lo_params.LidarOdometryParams(), n_streams=2, **kw),
    lambda **kw: FleetLIO(_lio_params(), n_streams=2, **kw),
    lambda **kw: FleetLIO(lo_params.LidarInertialOdometryParams(), n_streams=2, **kw),
    lambda **kw: PreprocessFilter(**kw),
    lambda **kw: LidarOdometry(_raw_params(), **kw),
], ids=["LidarOdometry", "Submap", "PCProcessor", "voxel_hash_map.create", "map_state_from_reference",
        "LidarInertialOdometry", "make_lio_inputs", "run_lio_replay", "lio_state_from_reference",
        "IMUPreintegration", "init_state", "State.identity", "scan_at_distorted", "PipelinedLidarOdometry",
        "PipelinedLidarInertialOdometry", "OdometryStreamServer", "FleetOdometry", "FleetOdometry-defaults",
        "FleetLIO", "FleetLIO-defaults", "PreprocessFilter", "LidarOdometry-raw-features"])
def test_lo_entry_points_raise_without_a_card(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make()
    made = make(device="cpu")
    assert getattr(made, "device", torch.device("cpu")).type == "cpu"


def _raw_params():
    """The ported parameter tree with the raw range-image covariances."""
    p = _vhm_params()
    return dataclasses.replace(p, covariance_estimation=dataclasses.replace(p.covariance_estimation,
                                                                            raw_range_image=True))


def _lio_params():
    """The LIO replay's parameters on a small map."""
    p = lio_replay.lio_params(np.eye(4))
    return lo_params.LidarInertialOdometryParams(
        scan=p.scan, imu=p.imu, pose=p.pose,
        submap=lo_params.SubmapParams(map_type="VOXEL_HASH_MAP", map_capacity=1 << 8, extract_capacity=1 << 6),
    )


# -- the fleet-LIO deployment against benchmarks/bench_fleet.py --lio -------------


def _bench_fleet_lio_params():
    """What ``bench_fleet.py --lio`` builds at its defaults (lines 101-133)."""
    from sycl_points_tpu.imu.preintegration import IMUPreintegrationParams
    from sycl_points_tpu.pipeline import params as P

    scan_params = P.ScanParams(downsampling=P.DownsamplingParams(
        voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
        random=P.RandomDownsamplingParams(enable=True, num=5000)))
    submap_params = P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 16,
                                   point_random_sampling_num=512)
    return P.LidarInertialOdometryParams(scan=scan_params, submap=submap_params, imu=P.IMUParams(
        enable=True, preintegration=IMUPreintegrationParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-5,
            accel_bias_rw_density=1e-4)))


def test_fleet_lio_params_equal_the_benchmark():
    assert fleet_replay.fleet_lio_params() == params_from_reference(_bench_fleet_lio_params())
    assert fleet_replay.fleet_params(default_trees=True) == lo_params.LidarOdometryParams()
    lio_def = fleet_replay.fleet_lio_params(default_trees=True)
    assert (lio_def.scan, lio_def.submap) == (lo_params.ScanParams(), lo_params.SubmapParams())
    assert lio_def.imu == fleet_replay.fleet_lio_params().imu
    assert not lio_def.imu.deskew.enable and not lio_def.imu.initial_alignment.enable


def test_fleet_imu_feed_equals_the_benchmark():
    """bench_fleet.py:136-145 and 154-173: each frame ``i`` feeds
    ``feed_imu(max(0.1 i - 0.1, -0.05), 0.1 i)`` to every stream, then after
    frame 0 seeds ``R_s v0``."""
    class Recorder:
        B = 3

        def __init__(self):
            self.got = [[] for _ in range(self.B)]

        def add_imu_measurement(self, s, m):
            self.got[s].append((m.timestamp, m.gyro, m.accel))

    ours, want = Recorder(), []
    for i in range(4):
        t_from, t_to = max(0.1 * i - 0.1, -0.05), 0.1 * i
        fleet_replay.feed_fleet_imu(ours, t_from, t_to)
        n = max(int(round((t_to - t_from) * 200.0)), 1)
        for k in range(n + 1):
            t = t_from + (t_to - t_from) * k / n
            g, a = ref_synth.figure8_imu(t, speed=0.35)
            want.append((t, g.astype(np.float32), a.astype(np.float32)))
    for got in ours.got:
        assert len(got) == len(want)
        for (t, g, a), (wt, wg, wa) in zip(got, want, strict=True):
            assert t == wt
            np.testing.assert_array_equal(g, wg)
            np.testing.assert_array_equal(a, wa)
    s_dot = 0.35 / (0.1 * 18.0)
    v0 = np.array([18.0 * s_dot, 18.0 * s_dot, 0.0], np.float32)
    for s, v in enumerate(fleet_replay.initial_velocities(8)):
        yaw = 2.0 * np.pi * s / 8
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]], np.float32)
        np.testing.assert_array_equal(v, R @ v0)
