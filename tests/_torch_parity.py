"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: the same numpy inputs go to both, and the outputs come back as
numpy for comparison."""

import numpy as np
import jax.numpy as jnp
import torch

import sycl_points_tpu_torch  # noqa: F401  (float32 settings)

# The tier-1 run uses several xdist workers on few cores: one torch thread
# each keeps them from oversubscribing the host.
torch.set_num_threads(1)


def both(arr):
    """``(jnp array, torch tensor)`` holding the same numpy values."""
    arr = np.asarray(arr)
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


def np_(x):
    """numpy copy of a jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clouds(points, capacity=None, **attrs):
    """The same padded cloud in both packages."""
    from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
    from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud

    return (
        JCloud.from_numpy(points, capacity=capacity, **attrs),
        TCloud.from_numpy(points, capacity=capacity, device="cpu", **attrs),
    )


def spd(rng, n, spread=(1e-3, 1.0)):
    """``n`` random symmetric positive-definite 3x3 matrices with
    well-separated eigenvalues in ``spread``."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.sort(rng.uniform(*spread, size=(n, 3)), axis=1)
    lam[:, 1] = np.maximum(lam[:, 1], lam[:, 0] * 1.5)
    lam[:, 2] = np.maximum(lam[:, 2], lam[:, 1] * 1.5)
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def rigid(rng, rot_scale=0.1, trans_scale=1.0):
    """A random rigid transform ``[4, 4]`` float32."""
    from sycl_points_tpu.utils import lie_np

    tw = np.concatenate([rng.normal(scale=rot_scale, size=3), rng.normal(scale=trans_scale, size=3)])
    return lie_np.se3_exp(tw).astype(np.float32)
