"""Work split over several cards: the source's points, a batch of queries or
a batch of scan pairs.

Counterpart of :mod:`sycl_points_tpu.parallel.sharded`. JAX shards arrays
over a ``Mesh`` and lets GSPMD insert the collectives. The port has no such
compiler: its mesh is a list of torch devices (:func:`make_mesh`, the visible
cards; the tests pass CPU entries), and each function places the parts on
them and gathers the results on the first device itself.

  * :func:`shard_cloud` splits a cloud's rows over the devices,
    :func:`replicate` copies a cloud (or a tensor) to each,
    :func:`stack_clouds` stacks clouds of one capacity on a leading axis;
  * :func:`sharded_align` splits ONE pair's source over the devices (the
    latency layout): every iteration each device searches its points
    against its copy of the target and forms its partial H, b, error and
    inlier count, and the partials are added on the first device, which is
    what GSPMD's ``psum`` does in JAX (``registration.align_shards``). On a
    one-device mesh it is ``align``, bit for bit;
  * :func:`sharded_knn` splits the queries;
  * :func:`align_pairs_batched` splits a batch of pairs (the throughput
    layout): each device runs its pairs through ``align_streams``, with no
    traffic between devices.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, KNNResult, brute_force_knn
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.registration import (
    RegistrationResult,
    align_shards,
    align_streams,
    make_shard,
)

Mesh = List[torch.device]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first ``n_devices`` (default: all) visible cards; raises without
    one. A mesh of CPU entries is a list the caller writes."""
    require_device("cuda")
    count = torch.cuda.device_count()
    n = n_devices or count
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} cards, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def _to(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, PointCloud):
        return PointCloud(**{f: _to(getattr(x, f), device) for f in x.__dataclass_fields__})
    return x.to(device)


def shard_cloud(cloud: PointCloud, mesh: Mesh) -> List[PointCloud]:
    """The cloud's rows cut into ``len(mesh)`` contiguous parts, part ``i``
    on ``mesh[i]`` (sizes differ by at most one row)."""
    n = len(mesh)
    fields = {f: getattr(cloud, f) for f in cloud.__dataclass_fields__}
    parts = {f: (None,) * n if v is None else torch.tensor_split(v, n) for f, v in fields.items()}
    return [_to(PointCloud(**{f: parts[f][i] for f in fields}), d) for i, d in enumerate(mesh)]


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` (a cloud or a tensor) on each device."""
    return [_to(tree, d) for d in mesh]


def stack_clouds(clouds) -> PointCloud:
    """Clouds of one capacity stacked into one ``[B, N]`` cloud (for
    :func:`align_pairs_batched`)."""
    first = clouds[0]
    return PointCloud(**{f: None if getattr(first, f) is None else torch.stack([getattr(c, f) for c in clouds])
                         for f in first.__dataclass_fields__})


def sharded_align(mesh: Mesh, source: PointCloud, target: PointCloud, params, initial_guess=None):
    """GICP (or any registration type) with ``source`` split over the mesh
    and ``target`` replicated; the result lies on ``mesh[0]``."""
    shards = [make_shard(params, s, t, BruteForceKNN.build(t))
              for s, t in zip(shard_cloud(source, mesh), replicate(target, mesh))]
    return align_shards(shards, params, initial_guess=None if initial_guess is None else initial_guess.to(mesh[0]))


def sharded_knn(mesh: Mesh, target: PointCloud, queries: torch.Tensor, k: int) -> KNNResult:
    """Exact k-NN with the queries split over the mesh, each device
    searching its part against its copy of the target; the results in query
    order on ``mesh[0]``."""
    parts = [brute_force_knn(t.points, t.mask, q.to(d).contiguous(), k)
             for d, t, q in zip(mesh, replicate(target, mesh), torch.tensor_split(queries, len(mesh)))]
    return KNNResult(torch.cat([p.indices.to(mesh[0]) for p in parts]),
                     torch.cat([p.distances.to(mesh[0]) for p in parts]))


def align_pairs_batched(mesh: Mesh, sources: PointCloud, targets: PointCloud, params,
                        initial_guesses=None) -> RegistrationResult:
    """Align ``B`` independent pairs, ``sources`` / ``targets`` from
    :func:`stack_clouds`, with the batch cut over the mesh: each device runs
    its pairs through ``align_streams`` (each pair's result is what
    ``align`` gives it alone, a converged pair idling). Returns the batched
    result on ``mesh[0]``."""
    B = sources.points.shape[0]
    if initial_guesses is None:
        initial_guesses = torch.eye(4, dtype=torch.float32, device=sources.points.device).expand(B, 4, 4)
    outs = []
    for s, t, T0 in zip(shard_cloud(sources, mesh), shard_cloud(targets, mesh),
                        torch.tensor_split(initial_guesses, len(mesh))):
        if s.points.shape[0] == 0:
            continue
        knn = BruteForceKNN(points=t.points, mask=t.mask)
        outs.append(align_streams(s, t, knn, params, initial_guess=T0.to(s.points.device).contiguous()))
    return RegistrationResult(*[
        torch.cat([o[i].to(mesh[0]) for o in outs]) if isinstance(outs[0][i], torch.Tensor)
        else max(o[i] for o in outs)
        for i in range(len(RegistrationResult._fields))])
