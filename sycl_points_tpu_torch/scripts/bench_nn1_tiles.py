"""The tile sweep of the exact 1-NN kernel on the card.

Counterpart of the TPU tile sweep ``scripts/bench_pallas_tiles.py``: the
same shapes and seed (``default_rng(0)``, uniform +-50 m, every target
valid), and the scan pair's (1,000 queries against the 24,576-row target,
:data:`PAIR_SHAPE`). Where the TPU swept the query tile and the target chunk
held in VMEM, the card runs:

  * ``cuda_knn.nn1_tiled``, the sweep's kernel designed for the card: query
    tile {64, 128, 256, 512} x target chunk {512, 1024, 2048, 4096} (two
    queries a thread, bulk-copied chunks, a split target), its target packed
    once a shape (``cuda_knn.pack_target``);
  * ``cuda_knn.nn1_tiled_simple``, its first design: threads per block {64,
    128, 256, 512} (one query each) x shared-memory tile {512, 1024, 2048,
    4096}, its instance (128, 2048), the first production nn1, first;
  * the production cluster ``nn1`` (``cuda_knn.nn1_prepped``, the target
    prepared once a shape).

For each (Q, M) and instance it prints the marginal ms per launch (CUDA
events around 1 and 17 back-to-back launches), queries per second, the share
of indices equal to ``nn1_plain``'s and the largest |d2 - plain| (every
instance must equal the plain version bit for bit), the share of indices
equal to the first instance's, and for each (Q, M) the bound
(``scripts.measure.nn1_bound``).

Usage: python -m sycl_points_tpu_torch.scripts.bench_nn1_tiles
"""

from __future__ import annotations

import functools

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts.bench_nn1_variants import raw_target, run_study

TPU_SHAPES = ((8192, 22528), (22528, 22528), (8192, 131072))
PAIR_SHAPE = (1000, 24576)
SHAPES = TPU_SHAPES + (PAIR_SHAPE,)
FIRST = (128, 2048)  # the first design's instance that was the first production nn1


def _simple(tm, q, threads, tile):
    return cuda_knn.nn1_tiled_simple(*tm, q, threads=threads, tile=tile)


def _tiled(packed, q, query_tile, chunk):
    return cuda_knn.nn1_tiled_prepped(packed, q, query_tile, chunk)


# label -> (its key in cuda_knn.launch_counts, the target's preparation on
# (targets, mask), the call on (prepared target, queries))
INSTANCES = {
    **{f"threads={th} tile={ti}": ("nn1_tiled_simple", raw_target,
                                   functools.partial(_simple, threads=th, tile=ti))
       for th, ti in [FIRST] + [(th, ti) for th in cuda_knn.NN1_THREADS for ti in cuda_knn.NN1_TILES
                                if (th, ti) != FIRST]},
    **{f"queries={qt} chunk={tc}": ("nn1_tiled", cuda_knn.pack_target,
                                    functools.partial(_tiled, query_tile=qt, chunk=tc))
       for qt in cuda_knn.NN1_QUERY_TILES_STUDY for tc in cuda_knn.NN1_TILES},
    "cluster nn1": ("nn1", cuda_knn.prep_target, lambda prep, q: cuda_knn.nn1_prepped(prep, q)),
}


def main(shapes=SHAPES, device: torch.device | str = "cuda") -> list[dict]:
    """Run the sweep on ``device`` (the card unless the caller asks for the
    CPU); returns one row per (Q, M, instance)."""
    return run_study(INSTANCES, shapes, 0, require_device(device))


if __name__ == "__main__":
    main()
