"""The Morton window's union pass with and without its rank placement, on the card.

Above k = 16 the union pass (``morton_warp_kernel<K, union>`` in
``csrc/window_knn.cu``, a warp a sorted position) places each entry of the
two passes' rows by its rank when both rows hold neighbours below 3e38 at
distinct values, and sorts the 2k entries twice (the general path, the
plain version's steps) otherwise. This study builds ``window_knn.cu`` a
second time with ``-DSPT_WINDOW_UNION_SORT_ONLY`` (the general path alone)
and times, in turns in one process, on the last scan of the smoke run's LO
replay (2048 x 64, W = 64): pass 1, the union pass as built, and the union
pass of the general path alone, at k = 10 (the thread kernel, the same code
in both builds: the control), 32, 64 and 128. Both builds must equal
``window_gather_plain``'s union bit for bit. It also prints the share of
positions whose rows take the rank placement.

Prints marginal CUDA-event ms (medians of ``--rounds`` turns), the card's
name and power limit, and one JSON object as the last line.

Usage: python -m sycl_points_tpu_torch.scripts.bench_window_union [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps.odometry_replay import make_scans
from sycl_points_tpu_torch.ops import cuda_knn, window_knn
from sycl_points_tpu_torch.scripts.measure import marginal_ms

WINDOW = 64
KS = (10, 32, 64, 128)
SORT_ONLY = "-DSPT_WINDOW_UNION_SORT_ONLY"


def build_sort_only() -> ctypes.CDLL:
    """``csrc/window_knn.cu`` alone with the general union path only, into
    the package's build directory; returns the loaded library."""
    src = os.path.join(cuda_knn.CSRC_DIR, "window_knn.cu")
    digest = hashlib.sha256(" ".join((*cuda_knn.NVCC_FLAGS, SORT_ONLY)).encode())
    for name in ("window_knn.cu", "best_k.cuh", "warp_sort.cuh"):
        with open(os.path.join(cuda_knn.CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(cuda_knn.BUILD_DIR, f"libspt_window_sort_only_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(cuda_knn.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([cuda_knn.find_nvcc(), *cuda_knn.NVCC_FLAGS, SORT_ONLY, "-shared", "-o", path + ".tmp",
                               src], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(path + ".tmp", path)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spt_morton_window_gather.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
    lib.spt_morton_window_gather.restype = i
    return lib


def union_sort_only(lib, pts, mask, order, k, prev):
    """The union pass through the general-path build (uncounted)."""
    N = pts.shape[0]
    out_i = torch.empty((N, k), dtype=torch.int32, device=pts.device)
    out_d = torch.empty((N, k), dtype=torch.float32, device=pts.device)
    err = lib.spt_morton_window_gather(pts.data_ptr(), mask.data_ptr(), order.data_ptr(), N, WINDOW, k, 1,
                                       prev[0].data_ptr(), prev[1].data_ptr(), out_i.data_ptr(), out_d.data_ptr(),
                                       torch.cuda.current_stream(pts.device).cuda_stream)
    if err:
        raise RuntimeError(f"the sort-only union pass failed with CUDA error {err}")
    return out_i, out_d


def rank_share(p1, p2) -> float:
    """Share of positions whose two rows (3e38 kept) hold only values below
    3e38, no two of a row equal: those the rank placement takes above k =
    16."""
    ok = torch.ones(p1[1].shape[0], dtype=torch.bool, device=p1[1].device)
    for _, d in (p1, p2):
        ok &= (d < window_knn.BIG).all(1) & (d[:, 1:] != d[:, :-1]).all(1)
    return float(ok.float().mean())


def in_turns(fns: dict, rounds: int, dev) -> dict:
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(marginal_ms(fns[name], dev))
    return {name: statistics.median(v) for name, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    dev = require_device("cuda")
    _, scans = make_scans(20, device=dev)
    pts, mask = scans[-1].points.contiguous(), scans[-1].mask.contiguous()
    cuda_knn.load_library()
    lib = build_sort_only()
    order = torch.sort(window_knn.morton_codes_passes(pts, mask, 0.5), dim=1, stable=True)[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = {}
    for k in KS:
        p1 = window_knn.window_gather(pts, mask, order[0], WINDOW, k)
        p2 = window_knn.window_gather(pts, mask, order[1], WINDOW, k)
        ref = window_knn.window_gather_plain(pts, mask, order[1], WINDOW, k, prev=p1)
        for name, got in (("as built", window_knn.window_gather(pts, mask, order[1], WINDOW, k, prev=p1)),
                          ("sort only", union_sort_only(lib, pts, mask, order[1], k, p1))):
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"the union pass ({name}) differs from its plain version at k={k}")
        t = in_turns({"pass_ms": lambda: window_knn.window_gather(pts, mask, order[0], WINDOW, k),
                      "union_ms": lambda: window_knn.window_gather(pts, mask, order[1], WINDOW, k, prev=p1),
                      "union_sort_only_ms": lambda: union_sort_only(lib, pts, mask, order[1], k, p1)},
                     args.rounds, dev)
        rows[k] = {**t, "rank_share": rank_share(p1, p2)}
        placed = ("the thread kernel, no rank placement" if k <= cuda_knn.FAST_MAX_K else
                  f"rank placement on {rows[k]['rank_share']:.4f} of the positions")
        print(f"k={k}: pass {t['pass_ms']:.4f} ms, union pass {t['union_ms']:.4f} (sort only "
              f"{t['union_sort_only_ms']:.4f}); {placed}; both equal the plain union bit for bit", flush=True)
    print(card)
    print(json.dumps({"card": card, "points": pts.shape[0], "valid": int(mask.sum()), "window": WINDOW,
                      "rounds": args.rounds, "rows": rows}))


if __name__ == "__main__":
    main()
