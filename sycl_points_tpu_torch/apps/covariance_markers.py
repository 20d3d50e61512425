"""Covariance ellipsoids as a PLY mesh.

Counterpart of :mod:`sycl_points_tpu.apps.covariance_markers`, the ROS-less
analog of the reference's covariance MarkerArray publisher: each point's 3x3
covariance becomes a small ellipsoid (a UV sphere scaled by the square roots
of the eigenvalues, turned into the eigenbasis, moved to the point), and the
ellipsoids of a cloud go into one binary PLY mesh that any viewer loads. The
eigen-decomposition is the port's closed-form ``eigh3``, on the cloud's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils.eigh3 import eigh3


def _unit_sphere(n_lat: int = 6, n_lon: int = 8):
    """A small UV sphere: vertices ``[V, 3]`` float32, faces ``[F, 3]`` int32."""
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, n_lat):
        phi = np.pi * i / n_lat
        for j in range(n_lon):
            th = 2 * np.pi * j / n_lon
            verts.append((np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)))
    verts.append((0.0, 0.0, -1.0))
    v = np.asarray(verts, np.float32)

    faces = [(0, 1 + j, 1 + (j + 1) % n_lon) for j in range(n_lon)]
    for i in range(n_lat - 2):
        a = 1 + i * n_lon
        b = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append((a + j, b + j, b + j2))
            faces.append((a + j, b + j2, a + j2))
    last = len(v) - 1
    a = 1 + (n_lat - 2) * n_lon
    faces += [(last, a + (j + 1) % n_lon, a + j) for j in range(n_lon)]
    return v, np.asarray(faces, np.int32)


def covariance_ellipsoid_mesh(cloud: PointCloud, scale: float = 2.0, max_markers: int = 500,
                              min_radius: float = 1e-3):
    """``(vertices [N*V, 3] float32, faces [N*F, 3] int32)`` of the first
    ``max_markers`` valid points' ellipsoids: semi-axes ``scale *
    sqrt(eigenvalue)`` (at least ``min_radius``) along the eigenvectors."""
    if cloud.covs is None:
        raise ValueError("cloud has no covariances")
    sel = torch.nonzero(cloud.mask).squeeze(1)[:max_markers]
    lam, V = eigh3(cloud.covs[sel])
    pts = cloud.points[sel].cpu().numpy()
    lam = np.maximum(lam.cpu().numpy(), 0.0)
    V = V.cpu().numpy()
    radii = np.maximum(scale * np.sqrt(lam), min_radius)  # [N, 3]

    sv, sf = _unit_sphere()
    # x_world = V diag(r) x_unit + p, a marker each
    rotated = np.einsum("nij,nvj->nvi", V, sv[None, :, :] * radii[:, None, :])
    verts = (rotated + pts[:, None, :]).reshape(-1, 3).astype(np.float32)
    offs = (np.arange(len(pts)) * len(sv))[:, None, None]
    faces = (sf[None, :, :] + offs).reshape(-1, 3).astype(np.int32)
    return verts, faces


def write_ellipsoid_ply(path: str, cloud: PointCloud, scale: float = 2.0, max_markers: int = 500) -> None:
    """Write the ellipsoids of :func:`covariance_ellipsoid_mesh` as a binary
    PLY mesh (float x/y/z vertices, uchar-int triangle lists)."""
    verts, faces = covariance_ellipsoid_mesh(cloud, scale, max_markers)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    rec = np.zeros(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    rec["n"] = 3
    rec["v"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        f.write(rec.tobytes())
