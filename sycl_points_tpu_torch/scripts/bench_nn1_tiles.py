"""Threads x shared-tile sweep of the exact 1-NN kernel on the card.

Counterpart of the TPU tile sweep ``scripts/bench_pallas_tiles.py``: the same
shapes and seed (``default_rng(0)``, uniform +-50 m, every target valid).
Where the TPU swept the query tile and the target chunk held in VMEM, the
card's kernel has threads per block (one query each) and the target tile
staged in shared memory: every instance of ``cuda_knn.nn1_tiled``,
threads {64, 128, 256, 512} x tile {512, 1024, 2048, 4096}, the production
instance (128, 2048) first.

For each (Q, M) and instance it prints the marginal ms per launch (CUDA
events around 1 and 17 back-to-back launches), queries per second, the share
of indices equal to ``nn1_plain``'s and the largest |d2 - plain| (every
instance must equal the plain version bit for bit), the share of indices
equal to the production instance's, and for each (Q, M) the bound
(``scripts.measure.nn1_bound``).

Usage: python -m sycl_points_tpu_torch.scripts.bench_nn1_tiles
"""

from __future__ import annotations

import functools

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts.bench_nn1_variants import run_study

SHAPES = ((8192, 22528), (22528, 22528), (8192, 131072))
PRODUCTION = (128, 2048)

# label -> (its key in cuda_knn.launch_counts, the call on (targets, mask, queries))
INSTANCES = {
    f"threads={th} tile={ti}": ("nn1_tiled", functools.partial(cuda_knn.nn1_tiled, threads=th, tile=ti))
    for th, ti in [PRODUCTION] + [
        (th, ti) for th in cuda_knn.NN1_THREADS for ti in cuda_knn.NN1_TILES if (th, ti) != PRODUCTION
    ]
}


def main(shapes=SHAPES, device: torch.device | str = "cuda") -> list[dict]:
    """Run the sweep on ``device`` (the card unless the caller asks for the
    CPU); returns one row per (Q, M, instance)."""
    return run_study(INSTANCES, shapes, 0, require_device(device))


if __name__ == "__main__":
    main()
