"""``correct``: each captured stage judged by the plain reference.

A reading is the widest over the run's samples; each has a limit in the
configuration file (``check.limits``), set from the readings of sound runs
and of the control (PERF.md). A reading that is not finite fails, and so
does a run in which a stage the configuration checks was never captured.
Two counts are held to 0: the window's stream-frames that did not resolve
as a success (``window_not_success``), and the sampled registrations among
them or never resolved (``sampled_not_success``), which are not judged.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import gicp, imu_lio, scan, voxel_map


def _judge_all(captures: dict, poses: dict, ref: dict) -> tuple:
    numbers, counts = {"sampled_not_success": 0.0}, {}

    def note(kind: str, values: dict) -> None:
        counts[kind] = counts.get(kind, 0) + 1
        for k, v in values.items():
            if k in ("skipped", "map_ambiguous"):
                counts[f"{kind}.{k}"] = counts.get(f"{kind}.{k}", 0) + v
                continue
            v = float(v) if math.isfinite(float(v)) else math.inf
            numbers[k] = max(numbers.get(k, 0.0), v)

    raw = {(c["frame"], c["stream"]): c for c in captures["raw"]}
    for c in captures["pre"]:
        r = raw[(c["frame"], c["stream"])]
        note("pre", scan.judge(r["points"], r["mask"], c["points"], c["mask"], c["covs"], ref["scan"]))
    for kind in ("reg", "lio"):
        for c in captures[kind]:
            got = poses.get((c["frame"], c["stream"]))
            if got is None or got[1].value != "success":
                numbers["sampled_not_success"] += 1
                continue
            T = torch.as_tensor(got[0], device=c["src"]["points"].device)  # the stream's own card
            s, t = c["src"], c["tgt"]
            if kind == "reg":
                note(kind, gicp.judge(T, c["init"], s["points"], s["mask"], s["covs"], t["points"], t["mask"],
                                      t["covs"], ref["registration"]))
            else:
                note(kind, imu_lio.judge(T, c, ref["lio"]))
    for c in captures["map"]:
        note("map", voxel_map.judge(c["prev"], c["sampled"]["points"], c["sampled"]["mask"], c["input"]["points"],
                                    c["input"]["mask"], c["T"], c["out"]["points"], c["out"]["mask"],
                                    c["out"]["covs"], ref["map"]))
    return numbers, counts


def control_captures(captures: dict, cfg: dict, seed: int) -> tuple:
    """The captures with each stage's output replaced by the control's: the
    reference computed in bfloat16 in the program's place, from the same
    inputs; and the poses it gives."""
    ref = cfg["reference"]
    out = {k: list(v) for k, v in captures.items()}
    poses = {}
    raw = {(c["frame"], c["stream"]): c for c in captures["raw"]}
    gens = {}

    def gen_for(t):
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(seed % (1 << 63))
        return gens[t.device]

    for i, c in enumerate(captures["pre"]):
        r = raw[(c["frame"], c["stream"])]
        p, m, cv = scan.control(r["points"], r["mask"], ref["scan"], gen_for(r["points"]))
        out["pre"][i] = dict(c, points=p, mask=m, covs=cv)
    for i, c in enumerate(captures["reg"]):
        s, t = c["src"], c["tgt"]
        T = gicp.control(c["init"], s["points"], s["mask"], s["covs"], t["points"], t["mask"], t["covs"],
                         ref["registration"])
        poses[(c["frame"], c["stream"])] = (T, _Success)
    for i, c in enumerate(captures["lio"]):
        x = imu_lio.control(c, ref["lio"])
        out["lio"][i] = dict(c, state=x)
        poses[(c["frame"], c["stream"])] = (imu_lio.pose(x), _Success)
    for i, c in enumerate(captures["map"]):
        (sp, sm), (p, m, cv) = voxel_map.control(c["prev"], c["input"]["points"], c["input"]["mask"], c["T"],
                                                 c["out"]["points"].shape[0], ref["map"], gen_for(c["T"]))
        out["map"][i] = dict(c, sampled={"points": sp, "mask": sm}, out={"points": p, "mask": m, "covs": cv})
    return out, poses


class _Success:
    value = "success"


def run(captures: dict, poses: dict, cfg: dict, failed: int = 0) -> dict:
    """``failed``: the window's stream-frames that resolved as anything but
    a success."""
    limits = cfg["check"]["limits"]
    numbers, counts = _judge_all(captures, poses, cfg["reference"])
    numbers["window_not_success"] = float(failed)
    missing = [k for k in cfg["check"]["stages"] if counts.get(k, 0) == 0]
    out = {k: [numbers.get(k, math.inf), limits[k]] for k in limits}
    correct = not missing and all(v <= lim for v, lim in out.values())
    if missing:
        counts["stages_never_captured"] = missing
    return {"correct": correct, "numbers": out, "counts": counts}
