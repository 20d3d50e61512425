"""Witnesses for what ``correct`` leaves out: one run of a cell, and on its
captured samples the reference again in float32 beside float64.

    python3 -m port_bench.witness --workload <name> --seed <n> --seconds <s> [--trace 0|1]

runs the cell as :mod:`port_bench.run` does (its result line, then its
checks on standard error) and, once the window has closed, prints one more
JSON line: for each thing the comparison leaves out, the widest reading with
it left in, of the program against the float64 reference, and of the same
reference in float32 against float64. Where float32 alone reads as the
program does, float32 rounding is what the exclusion leaves out:

- ``scan_cov``: covariances whose first estimate's condition number is over
  ``cov_max_condition`` (the robust re-estimate divides by it);
- ``scan_normal``: the normal's angle not weighed by the eigen-gap;
- ``scan_tie`` / ``map_tie``: neighbourhoods whose k-th and (k+1)-th
  neighbours float32 cannot tell apart, read against both neighbourhoods;
- ``map_voxels``: voxels on one side only, and how many of those lie
  outside the ambiguous set that the comparison leaves out;
- ``reg``: the registration's distance to the objective's fixed point (50
  iterations, steps under 1e-10), of the program and of its procedure (the
  iteration budget and the step test) run in float64 and float32.
"""

from __future__ import annotations

import json
import sys

import torch

from port_bench import check, run
from port_bench.reference import gicp, scan, voxel_map
from port_bench.reference.common import boundary_tie, covariances, covariances_geman_mcclure, eigh, knn

F64, F32 = torch.float64, torch.float32


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Frobenius gap of ``a`` from ``b`` over ``b``'s norm, a row each."""
    return (a - b).flatten(-2).norm(dim=-1) / b.flatten(-2).norm(dim=-1)


def _sine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sine of the angle between the smallest eigenvectors."""
    c = (eigh(a)[1][..., :, 0] * eigh(b)[1][..., :, 0]).sum(-1).abs().clamp(max=1.0)
    return torch.sqrt(1.0 - c * c)


def _max(x: torch.Tensor, where: torch.Tensor) -> float:
    return float(x[where].max()) if bool(where.any()) else 0.0


def _swap(idx: torch.Tensor, k: int) -> torch.Tensor:
    """The neighbourhood with its k-th and (k+1)-th neighbours swapped."""
    out = idx[:, :k].clone()
    out[:, k - 1] = idx[:, k]
    return out


def _neighbourhoods(p: torch.Tensor, k: int):
    return knn(p, torch.ones(p.shape[0], dtype=torch.bool, device=p.device), p, k + 1)


def witness_scan(c: dict, raw: dict, cfg: dict, acc: dict) -> None:
    keys, _ = scan.voxel_centroids(raw["points"], raw["mask"], cfg)
    cap = min(cfg["scan_capacity"], raw["points"].shape[0])
    L = min(cfg["random_num"], keys.shape[0]) if cfg["random_num"] < cap else keys.shape[0]
    if keys.shape[0] > cap or L == 0:
        return
    k = cfg["neighbor_num"]
    robust = (cfg["mad_scale"], cfg["min_robust_scale"], cfg["robust_iterations"])
    prog = c["covs"][:L].to(F64)
    m = c["mask"][:L].bool()
    p = c["points"][:L].to(F64)
    idx, d2 = _neighbourhoods(p, k)
    tie = boundary_tie(p, d2, k)
    ref = covariances_geman_mcclure(p, idx[:, :k], d2[:, :k], *robust)
    alt = covariances_geman_mcclure(p, _swap(idx, k), d2[:, :k], *robust)
    p32 = c["points"][:L].to(F32)
    i32, e32 = _neighbourhoods(p32, k)
    r32 = covariances_geman_mcclure(p32, i32[:, :k], e32[:, :k], *robust).to(F64)
    lam = eigh(ref)[0]
    kappa = lam[:, 2] / lam[:, 0].clamp_min(1e-300)
    well = kappa <= cfg["cov_max_condition"]
    judged = m & ~tie
    gp, g32 = _rel(prog, ref), _rel(r32, ref)
    _up(acc, "scan_cov", {"program_all": _max(gp, judged), "f32_all": _max(g32, judged),
                          "program_well": _max(gp, judged & well), "f32_well": _max(g32, judged & well),
                          "points_left_out": int((judged & ~well).sum()), "points_judged": int(judged.sum())})
    _up(acc, "scan_normal", {"program_sine": _max(_sine(prog, ref), judged),
                             "f32_sine": _max(_sine(r32, ref), judged)})
    either = torch.minimum(gp, _rel(prog, alt))
    _up(acc, "scan_tie", {"program": _max(gp, m & tie & well), "program_either": _max(either, m & tie & well),
                          "f32": _max(g32, m & tie & well), "points": int((m & tie).sum())})


def witness_map(c: dict, cfg: dict, acc: dict) -> None:
    codes64, _, amb = voxel_map.step(c["prev"], c["sampled"]["points"], c["sampled"]["mask"], c["T"], cfg)
    codes32, _, _ = voxel_map.step(c["prev"], c["sampled"]["points"], c["sampled"]["mask"], c["T"], cfg, F32)
    om = c["out"]["mask"].bool()
    op = c["out"]["points"][om].to(F64)
    oc = voxel_map._codes(torch.floor(op / cfg["voxel"]).long())
    one_p = torch.cat([codes64[~torch.isin(codes64, oc)], oc[~torch.isin(oc, codes64)]])
    one_32 = torch.cat([codes64[~torch.isin(codes64, codes32)], codes32[~torch.isin(codes32, codes64)]])
    _up(acc, "map_voxels", {"program_one_side": one_p.numel(), "program_outside_ambiguous":
                            int((~torch.isin(one_p, amb)).sum()), "f32_one_side": one_32.numel(),
                            "f32_outside_ambiguous": int((~torch.isin(one_32, amb)).sum()), "ambiguous": amb.numel()})
    k = cfg["neighbor_num"]
    idx, d2 = _neighbourhoods(op, k)
    tie = boundary_tie(op, d2, k)
    ref = covariances(op, idx[:, :k], d2[:, :k])
    alt = covariances(op, _swap(idx, k), d2[:, :k])
    op32 = c["out"]["points"][om].to(F32)
    i32, e32 = _neighbourhoods(op32, k)
    r32 = covariances(op32, i32[:, :k], e32[:, :k]).to(F64)
    prog = c["out"]["covs"][om].to(F64)
    gp = _rel(prog, ref)
    _up(acc, "map_tie", {"program": _max(gp, tie), "program_either": _max(torch.minimum(gp, _rel(prog, alt)), tie),
                         "f32": _max(_rel(r32, ref), tie), "program_clean": _max(gp, ~tie),
                         "f32_clean": _max(_rel(r32, ref), ~tie), "points": int(tie.sum())})


def witness_reg(c: dict, T_prog: torch.Tensor, cfg: dict, acc: dict) -> None:
    s, t = c["src"], c["tgt"]
    args = (c["init"], s["points"], s["mask"], s["covs"], t["points"], t["mask"], t["covs"], cfg["max_corr_dist"])
    fixed = gicp.refine(*args, iterations=50, tol=1e-10)
    proc = {dt: gicp.refine(*args, iterations=cfg["max_iterations"], tol=cfg["criteria"], dtype=dt).to(F64)
            for dt in (F64, F32)}

    def gap(a, b):
        return float((a[:3, 3] - b[:3, 3]).norm())

    T = T_prog.to(F64)
    _up(acc, "reg", {"program_to_fixed_m": gap(T, fixed), "f64_procedure_to_fixed_m": gap(proc[F64], fixed),
                     "f32_procedure_to_fixed_m": gap(proc[F32], fixed), "program_to_f64_procedure_m":
                     gap(T, proc[F64]), "f32_procedure_to_f64_procedure_m": gap(proc[F32], proc[F64])})


def _up(acc: dict, kind: str, values: dict) -> None:
    """The widest reading of each, and the sum of each count."""
    d = acc.setdefault(kind, {})
    for key, v in values.items():
        d[key] = d.get(key, 0) + v if isinstance(v, int) else max(d.get(key, 0.0), v)


def witness(captures: dict, poses: dict, cfg: dict) -> dict:
    ref = cfg["reference"]
    acc: dict = {}
    raw = {(c["frame"], c["stream"]): c for c in captures["raw"]}
    for c in captures["pre"]:
        witness_scan(c, raw[(c["frame"], c["stream"])], ref["scan"], acc)
    for c in captures["map"]:
        witness_map(c, ref["map"], acc)
    for c in captures["reg"]:
        got = poses.get((c["frame"], c["stream"]))
        if got is not None:
            witness_reg(c, torch.as_tensor(got[0], device=c["src"]["points"].device), ref["registration"], acc)
    return acc


def main(argv=None) -> int:
    found = {}
    judge = check.run

    def run_and_witness(captures, poses, cfg, **kw):
        out = judge(captures, poses, cfg, **kw)
        found.update(witness(captures, poses, cfg))
        return out

    check.run = run_and_witness
    rc = run.main(argv)
    print(json.dumps({"witness": found}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
