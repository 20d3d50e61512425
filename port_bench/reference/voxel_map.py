"""The submap step on the voxel-hash map: insert, prune, extract, finalize.

The stage's inputs are the map the program held before the step (its used
voxels: coordinates, position sums, counts, stamps and frame counter), the
sample it inserts and the registered pose. The sample is the program's
random draw: it is checked to be points of the registration's input, and
the rest is worked out again: each sampled point's voxel in the map frame,
the sums, the staleness pruning of every ``cycle``-th insert, the voxels
whose centroids lie in the box around the pose (the nearest up to the
extraction's capacity), and their neighbourhood covariances.

A voxel that a point within ``ambiguous_m`` of a voxel face touches, or a
centroid within that distance of the box's face, may fall either way under
float32 rounding: it is left out of the comparison, and counted.
"""

from __future__ import annotations

import torch

from port_bench.reference.common import boundary_tie, covariances, knn


def _codes(keys: torch.Tensor) -> torch.Tensor:
    """One int64 a voxel key (21 bits an axis, offset)."""
    k = keys + (1 << 20)
    return (k[..., 0] << 42) | (k[..., 1] << 21) | k[..., 2]


def map_keys(prev: dict) -> torch.Tensor:
    """The voxel keys of the map's used slots. The table stores them with
    an offset; it is read off the slots' own centroids (the most common
    difference), not assumed."""
    used = prev["used"].bool()
    coords = prev["coords"][used].long()
    if coords.shape[0] == 0:
        return coords
    cent = prev["sum_pos"][used].double() / prev["count"][used].double().clamp_min(1.0)[:, None]
    diff = coords - torch.floor(cent / prev["voxel"]).long()
    offset = torch.mode(diff, dim=0).values
    return coords - offset


def step(prev: dict, sampled_pts, sampled_mask, T, cfg: dict, dtype=torch.float64):
    """The map after inserting the sample at ``T`` and the extracted target:
    ``(codes [V], centroids [V, 3], ambiguous codes)``, nearest first."""
    vs = cfg["voxel"]
    prev = dict(prev, voxel=vs)
    dev = sampled_pts.device
    T = T.to(dtype)
    p = sampled_pts[sampled_mask.bool()].to(dtype) @ T[:3, :3].T + T[:3, 3]
    q = p / vs
    keys = torch.floor(q).long()
    frac = q - torch.floor(q)
    near = ((frac < cfg["ambiguous_m"] / vs) | (frac > 1.0 - cfg["ambiguous_m"] / vs))
    amb = [_codes(keys[near.any(-1)])]
    for a in range(3):  # the voxel across the face too
        other = keys.clone()
        other[:, a] += torch.where(frac[:, a] < 0.5, -1, 1)
        amb.append(_codes(other[near[:, a]]))
    new_codes = _codes(keys)

    used = prev["used"].bool()
    old_codes = _codes(map_keys(prev))
    codes = torch.cat([old_codes, new_codes])
    uc, inv = torch.unique(codes, return_inverse=True)
    V = uc.shape[0]
    n_old = old_codes.shape[0]
    sums = torch.zeros((V, 3), dtype=dtype, device=dev)
    sums.index_add_(0, inv[:n_old], prev["sum_pos"][used].to(dtype))
    sums.index_add_(0, inv[n_old:], p)
    cnt = torch.zeros(V, dtype=dtype, device=dev)
    cnt.index_add_(0, inv[:n_old], prev["count"][used].to(dtype))
    cnt.index_add_(0, inv[n_old:], torch.ones_like(p[:, 0]))
    frame = int(prev["frame"])
    stamp = torch.full((V,), -(1 << 40), dtype=torch.long, device=dev)
    stamp[inv[:n_old]] = prev["last_update"][used].long()
    stamp[inv[n_old:]] = frame
    new_frame = frame + 1
    keep = torch.ones(V, dtype=torch.bool, device=dev)
    if cfg["prune_cycle"] > 0 and new_frame % cfg["prune_cycle"] == 0:
        keep = (new_frame - 1 - stamp) <= cfg["max_staleness"]

    cent = sums / torch.clamp_min(cnt, 1.0)[:, None]
    center = T[:3, 3]
    dist = (cent - center).abs().amax(-1)
    D = cfg["max_distance"]
    inside = keep & (cnt >= cfg["min_num_point"]) & (dist <= D)
    edge = keep & ((dist - D).abs() <= cfg["ambiguous_m"])
    d2 = ((cent - center) ** 2).sum(-1)
    order = torch.argsort(torch.where(inside, d2, torch.full_like(d2, torch.inf)).double(), stable=True)
    n_in = int(inside.sum())
    cap = cfg["extract_capacity"]
    take = order[: min(n_in, cap)]
    if n_in > cap:  # the voxels tied at the cut
        cut = d2[order[cap - 1]]
        amb.append(uc[inside & ((d2 - cut).abs() <= 2 * cfg["ambiguous_m"] * torch.sqrt(cut))])
    amb.append(uc[edge])
    return uc[take], cent[take], torch.unique(torch.cat(amb))


def judge(prev: dict, sampled_pts, sampled_mask, input_pts, input_mask, T, out_pts, out_mask, out_covs,
          cfg: dict) -> dict:
    """Readings of one submap step: ``map_sample_errors`` (sampled points
    that are not points of the registration's input), ``map_point_gap_m``
    (the widest centroid gap; 1 m for a voxel on one side only) and
    ``map_cov_rel_gap`` (the widest gap of the target's covariances, worked
    out again among its own points, over the reference's norm), the
    ambiguous voxels left out of the first two."""
    f64 = torch.float64
    sm = sampled_mask.bool()
    inp = input_pts[input_mask.bool()]
    s = sampled_pts[sm]
    if s.shape[0] and inp.shape[0]:
        exact = ((s[:, None, :] == inp[None, :, :]).all(-1)).any(1)
        sample_errors = int((~exact).sum())
    else:
        sample_errors = int(s.shape[0] > 0)
    out = {"map_sample_errors": sample_errors, "map_point_gap_m": 0.0, "map_cov_rel_gap": 0.0}
    codes, cents, amb = step(prev, sampled_pts, sampled_mask, T, cfg)
    if codes.shape[0] < cfg["min_num_points"]:
        out["skipped"] = 1
        return out
    om = out_mask.bool()
    op = out_pts[om].to(f64)
    oc = _codes(torch.floor(op / cfg["voxel"]).long())
    ra = torch.isin(codes, amb)
    pa = torch.isin(oc, amb)
    missing = ~torch.isin(codes, oc) & ~ra
    extra = ~torch.isin(oc, codes) & ~pa
    gap = 1.0 if bool(missing.any() or extra.any()) else 0.0
    sc, sidx = torch.sort(codes)
    pos = torch.searchsorted(sc, oc).clamp_max(sc.shape[0] - 1)
    match = (sc[pos] == oc) & ~pa
    rows = sidx[pos]
    if match.any():
        gap = max(gap, float((op[match] - cents[rows[match]]).norm(dim=-1).max()))
    out["map_point_gap_m"] = gap

    # the finalize stage on its own input: the covariances of the program's
    # extracted points among themselves (which points were extracted is
    # judged above)
    k = cfg["neighbor_num"]
    n = op.shape[0]
    idx, d2 = knn(op, torch.ones(n, dtype=torch.bool, device=op.device), op, k + 1)
    ref = covariances(op, idx[:, :k], d2[:, :k])
    clean = ~boundary_tie(op, d2, k)
    if clean.any():
        pc = out_covs[om].to(f64)[clean]
        rc = ref[clean]
        out["map_cov_rel_gap"] = float(((pc - rc).flatten(-2).norm(dim=-1) / rc.flatten(-2).norm(dim=-1)).max())
    out["map_ambiguous"] = int(ra.sum())
    return out


def control(prev: dict, input_pts, input_mask, T, capacity: int, cfg: dict, gen: torch.Generator,
            dtype=torch.bfloat16):
    """The stage in ``dtype`` in the program's place: a uniform sample of
    the registration's input (``gen``), the insert, the extraction and the
    covariances, in the program's layout ``((sampled points, mask), (points
    [M, 3], mask [M], covs [M, 3, 3]))``."""
    pts = input_pts.to(dtype)
    valid = input_mask.bool()
    idx = torch.nonzero(valid)[:, 0]
    pick = idx[torch.randperm(idx.numel(), generator=gen, device=gen.device).to(idx.device)[: cfg["sample_num"]]]
    take = torch.zeros_like(valid)
    take[pick] = True
    sampled = (pts.float(), take)
    _, cents, _ = step(prev, pts, take, T, cfg, dtype)
    n = min(cents.shape[0], capacity)
    cents = cents[:n]
    k = cfg["neighbor_num"]
    idx, d2 = knn(cents, torch.ones(n, dtype=torch.bool, device=cents.device), cents, k)
    covs = covariances(cents, idx, d2)
    dev = cents.device
    out = torch.zeros((capacity, 3), device=dev)
    mask = torch.zeros(capacity, dtype=torch.bool, device=dev)
    cv = torch.eye(3, device=dev).repeat(capacity, 1, 1)
    out[:n], mask[:n], cv[:n] = cents.float(), True, covs.float()
    return sampled, (out, mask, cv)
