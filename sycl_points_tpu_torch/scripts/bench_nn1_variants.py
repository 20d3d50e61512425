"""Variant study of the exact 1-NN kernel on the card.

Counterpart of the TPU study ``scripts/bench_nn1_variants.py``: the same
shapes, seed and masking (``default_rng(0)``, uniform +-50 m, every 37th
target masked), the same formulations as hand-written CUDA kernels:

  v0  the production ``nn1`` (one thread a query, +inf staging of masked
      targets)
  v1  ``nn1_bias``: masking by an added 0 / 3e38 bias
  v2  ``nn1_lanes``: 8 or 32 lanes a query, one shuffle reduce at the end
  v3  ``nn1_unroll2``: two targets a step

For each (Q, M) and variant it prints the marginal ms per launch (CUDA
events around 1 and 17 back-to-back launches), queries per second, the share
of indices equal to ``nn1_plain``'s and the largest |d2 - plain| (every
kernel must equal the plain version bit for bit), the share of indices equal
to v0's, and for each (Q, M) the bound (``scripts.measure.nn1_bound``).

Usage: python -m sycl_points_tpu_torch.scripts.bench_nn1_variants
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts.measure import marginal_ms, nn1_bound

SHAPES = ((22528, 22528), (8192, 131072), (1024, 6144))
MASK_EVERY = 37

# label -> (its key in cuda_knn.launch_counts, the call on (targets, mask,
# queries)); the first is v0, the production instance.
INSTANCES = {
    "v0-prod": ("nn1", lambda t, m, q: cuda_knn.nn1(t, m, q)),
    "v1-bias": ("nn1_bias", cuda_knn.nn1_bias),
    "v2-lanes8": ("nn1_lanes", lambda t, m, q: cuda_knn.nn1_lanes(t, m, q, 8)),
    "v2-lanes32": ("nn1_lanes", lambda t, m, q: cuda_knn.nn1_lanes(t, m, q, 32)),
    "v3-unroll2": ("nn1_unroll2", cuda_knn.nn1_unroll2),
}


def study_inputs(rng, Q: int, M: int, mask_every: int, device):
    """Targets, uint8 mask and queries as the TPU studies draw them: targets
    first, then queries, uniform in +-50 m; every ``mask_every``-th target
    masked (none when 0)."""
    t = rng.uniform(-50, 50, (M, 3)).astype(np.float32)
    mask = np.ones((M,), np.uint8)
    if mask_every:
        mask[::mask_every] = 0
    q = rng.uniform(-50, 50, (Q, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (t, mask, q))


def agreement(idx, d2, ref_idx, ref_d2) -> tuple[float, float]:
    """(share of indices equal to the reference's, largest |d2 - ref|, with
    two infinities counted as equal)."""
    agree = float((idx == ref_idx).double().mean())
    diff = torch.where(d2 == ref_d2, 0.0, (d2 - ref_d2).abs())
    return agree, float(diff.max()) if diff.numel() else 0.0


def run_study(instances: dict, shapes, mask_every: int, device) -> list[dict]:
    """Each instance at each (Q, M), held against ``nn1_plain`` (``agree``,
    ``dmax``) and against the first instance (``agree_v0``)."""
    rng = np.random.default_rng(0)
    rows = []
    for Q, M in shapes:
        t, m, q = study_inputs(rng, Q, M, mask_every, device)
        b_ms, b_by = nn1_bound(Q, M, int(m.sum()))
        print(f"Q={Q} M={M} (valid {int(m.sum())}): bound {b_ms:.4g} ms ({b_by})", flush=True)
        plain = cuda_knn.nn1_plain(t, m, q)
        first = None
        for name, (_, fn) in instances.items():
            idx, d2 = fn(t, m, q)
            if first is None:
                first = idx
            agree, dmax = agreement(idx, d2, *plain)
            agree_v0 = float((idx == first).double().mean())
            ms = marginal_ms(lambda: fn(t, m, q), device)
            rows.append({"Q": Q, "M": M, "name": name, "ms": ms, "agree": agree, "dmax": dmax,
                         "agree_v0": agree_v0})
            print(f"Q={Q} M={M} {name}: {ms:8.4f} ms ({Q / ms / 1e3:8.1f} Mq/s) "
                  f"idx_agree(plain)={agree:.4f} dmax(plain)={dmax:.2e} idx_agree(v0)={agree_v0:.4f}",
                  flush=True)
    return rows


def main(shapes=SHAPES, device: torch.device | str = "cuda") -> list[dict]:
    """Run the variant study on ``device`` (the card unless the caller asks
    for the CPU); returns one row per (Q, M, variant)."""
    return run_study(INSTANCES, shapes, MASK_EVERY, require_device(device))


if __name__ == "__main__":
    main()
