"""The kernels' least time: the benchmark's copy of the count in
``sycl_points_tpu_torch/scripts/measure.py``.

A brute-force nearest-neighbour search does 9 FP32 instructions a (query,
valid target row) pair (3 sub, 3 mul, 2 add, 1 compare; the kernels are
built with ``--fmad=false``), at 33.5e12 a second (NVIDIA's data-sheet 67
TFLOP/s FP32 of the H100 SXM counts an FMA as two), and reads each input
row once and writes each result once, at 3.35 TB/s. A launch's least time
is the larger of the two. Rows count as the inputs need them: the valid
rows of each stream's target, and for a self search as many queries.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
OPS_PER_PAIR = 9


def launch_work(kind: str, rows, Q: int, k: int) -> tuple:
    """``(pairs, bytes)`` of one batched launch: ``rows`` the valid target
    rows of each stream; ``Q`` queries a stream (a self search's queries are
    its valid rows)."""
    rows = [int(r) for r in rows]
    if kind == "nn1":
        # queries (12 B) in, pose (64 B) a stream, idx and d2 (8 B) out; a
        # target row is its coordinates (12 B) and its mask (1 B)
        pairs = sum(Q * r for r in rows)
        n_bytes = sum(13 * r + 20 * Q + 64 for r in rows)
    else:
        pairs = sum(r * r for r in rows)
        n_bytes = sum(13 * r + 12 * r + 8 * k * r for r in rows)
    return pairs, n_bytes


def least_time(pairs: int, n_bytes: int) -> float:
    return max(pairs * OPS_PER_PAIR / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def least_seconds(launches) -> dict:
    """Each kind's summed least time over ``(kind, rows, Q, k)`` launches."""
    out = {}
    for kind, rows, Q, k in launches:
        out[kind] = out.get(kind, 0.0) + least_time(*launch_work(kind, rows, Q, k))
    return out


def share_pct(least_s, device_s):
    """The roofline share in %, or None where nothing was read."""
    if not least_s or not device_s:
        return None
    return 100.0 * least_s / device_s
