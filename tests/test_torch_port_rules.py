"""The port stands on its own and runs on the card unless asked for the CPU.

  * no module of ``sycl_points_tpu_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``sycl_points_tpu``, ``scripts`` or ``benchmarks`` (an ``ast``
    walk over the sources);
  * the port's own copies equal the originals exactly: the PLY/PCD readers
    on files written by ``sycl_points_tpu.points.io`` (ascii, binary,
    big-endian PLY, binary_compressed PCD), ``finite_filter``, and
    ``World``, ``hdl64_dirs``, ``figure8_trajectory`` of
    ``benchmarks/synthetic_velodyne.py``;
  * the entry points default to ``"cuda"`` and raise without a card.
"""

import ast
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

from sycl_points_tpu.points import io as ref_io  # noqa: E402
from sycl_points_tpu_torch.apps import example_registration  # noqa: E402
from sycl_points_tpu_torch.convert import cloud_from_numpy  # noqa: E402
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


def test_finite_filter_equals_the_original():
    cloud = _cloud(50, seed=1)
    cloud["points"][::7] = np.nan
    cloud["points"][3, 1] = np.inf
    _assert_same(port_io.finite_filter(cloud), ref_io._finite_filter(cloud))


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


@pytest.mark.parametrize("fn", [cloud_from_numpy, PointCloud.from_numpy, synthetic.scan_at,
                                bench_nn1_tiles.main, bench_nn1_variants.main])
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
    assert cloud_from_numpy(pts, device="cpu").device.type == "cpu"
