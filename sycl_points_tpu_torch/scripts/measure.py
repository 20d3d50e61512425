"""Kernel timing and bounds on the card, shared by the studies and the smoke run.

``marginal_ms`` times a call as the kernels' own work: CUDA events around
back-to-back launches queued behind idle device work, differenced over two
launch counts. ``bound`` is the least time the card could take for a
brute-force nearest-neighbour search: the larger of its bytes over the
memory rate and its FP32 operations over the FP32 rate, with NVIDIA's data-
sheet peaks of the H100 SXM (3.35 TB/s; 67 TFLOP/s FP32, which
counts an FMA as two operations: the kernels are built with --fmad=false, so
each of a pair's 9 operations, 3 sub, 3 mul, 2 add and 1 compare, is one lane
instruction, 33.5e12 a second).
"""

from __future__ import annotations

import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
OPS_PER_PAIR = 9

# Device cycles of idle work queued ahead of a timed run (~1 ms at 2 GHz),
# so the host has enqueued every launch before the first one starts and the
# events time the kernels, not the Python wrapper between them.
_LEAD_CYCLES = 2_000_000
# A call slower than this is timed once over 1 and 3 launches: its fixed
# costs are negligible, and 17 launches would take seconds.
_SLOW_MS = 20.0


def marginal_ms(fn, device: torch.device, reps=(1, 17), iters=3) -> float:
    """Per-launch time (ms) of ``fn``: the best of ``iters`` timings of
    ``reps[0]`` and of ``reps[1]`` back-to-back calls, differenced over the
    calls between them, so the fixed cost of a timing drops out. CUDA events
    on the card (behind queued idle work), the host clock on the CPU."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    if (time.perf_counter() - t0) * 1e3 > _SLOW_MS:
        reps, iters = (reps[0], reps[0] + 2), 1
    best = {}
    for n in reps:
        best[n] = np.inf
        for _ in range(iters):
            if cuda:
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_LEAD_CYCLES)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                ms = (time.perf_counter() - t0) * 1e3
            best[n] = min(best[n], ms)
    return (best[reps[1]] - best[reps[0]]) / (reps[1] - reps[0])


def bound(pairs: int, n_bytes: int) -> tuple[float, str]:
    """(least ms for the work, what bounds it): the larger of ``n_bytes`` over
    the memory rate and the ``pairs``' FP32 operations over the FP32 rate."""
    t_ops, t_bytes = pairs * OPS_PER_PAIR / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nn1_bound(Q: int, M: int, n_valid: int) -> tuple[float, str]:
    """1-NN: a distance to every valid target per query; reads the targets
    (12 B), the mask (1 B) and the queries once, writes idx and d2."""
    return bound(Q * n_valid, 13 * M + 12 * Q + 8 * Q)
