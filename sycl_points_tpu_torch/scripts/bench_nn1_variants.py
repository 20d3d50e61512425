"""Variant study of the exact 1-NN kernel on the card.

Counterpart of the TPU study ``scripts/bench_nn1_variants.py``: the same
shapes, seed and masking (``default_rng(0)``, uniform +-50 m, every 37th
target masked), plus the scan pair's (1,000 queries against the 24,576-row
target, :data:`PAIR_SHAPE`), and the same formulations as hand-written CUDA
kernels:

  v0  the production ``nn1`` (``cuda_knn.nn1_prepped``, the cluster kernel,
      on a target made once by ``prep_target``)
  v1  ``nn1_bias``: masking by an added 0 / 3e38 bias, in ``nn1_tiled``'s
      bulk-copied ring (``cuda_knn.nn1_bias_prepped`` on a target made once
      by ``pack_bias_target``); its first design ``nn1_bias_simple``
  v2  ``nn1_lanes``: 8 or 32 lanes a query, each with its own running best,
      one shuffle reduce a split, as the lane form of the same ring
      (``nn1_lanes_prepped`` on the same target); its first design
      ``nn1_lanes_simple``
  v3  ``nn1_unroll2``: two adjacent rows a step, in the same ring
      (``nn1_unroll2_prepped``); its first design ``nn1_unroll2_simple``

For each (Q, M) and variant it prints the marginal ms per launch (CUDA
events around 1 and 17 back-to-back launches; the median of :data:`TURNS`
timings taken in turns, every instance in order, then in reverse), queries
per second, the share of indices equal to ``nn1_plain``'s and the largest
|d2 - plain| (every kernel must equal the plain version bit for bit), the
share of indices equal to v0's, and for each (Q, M) the bound
(``scripts.measure.nn1_bound``).

``--sweep`` adds v1, v2 at both lane counts, v3 and ``nn1_tiled`` at every
query tile x chunk (:data:`SWEEP`; a lane form's query tile counts (query,
lane) slots; the fastest v1 / v2 / v3 at the pair's shape is
``cuda_knn.NN1_BIAS_INSTANCE`` / ``NN1_LANES_INSTANCE`` /
``NN1_UNROLL2_INSTANCE``), and times ``nn1_plain`` and the library call
(``torch.cdist`` over +inf-masked targets, then ``min``) in turns of their
own; it prints each design's fastest instance at each shape.

Usage: python -m sycl_points_tpu_torch.scripts.bench_nn1_variants [--sweep]
"""

from __future__ import annotations

import argparse
import functools
import statistics

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts.measure import marginal_ms, nn1_bound

TPU_SHAPES = ((22528, 22528), (8192, 131072), (1024, 6144))
PAIR_SHAPE = (1000, 24576)
SHAPES = TPU_SHAPES + (PAIR_SHAPE,)
MASK_EVERY = 37
TURNS = 4


def raw_target(t, m):
    """The target as the first designs read it: the raw points and mask."""
    return t, m


# label -> (its key in cuda_knn.launch_counts, the target's preparation on
# (targets, mask), made once a shape and not timed, the call on (prepared
# target, queries)); the first is v0, the production instance.
INSTANCES = {
    "v0-prod": ("nn1", cuda_knn.prep_target, lambda prep, q: cuda_knn.nn1_prepped(prep, q)),
    "v1-bias": ("nn1_bias", cuda_knn.pack_bias_target, lambda packed, q: cuda_knn.nn1_bias_prepped(packed, q)),
    "v1-bias-simple": ("nn1_bias_simple", raw_target, lambda tm, q: cuda_knn.nn1_bias_simple(*tm, q)),
    "v2-lanes8": ("nn1_lanes", cuda_knn.pack_bias_target,
                  lambda packed, q: cuda_knn.nn1_lanes_prepped(packed, q, 8)),
    "v2-lanes32": ("nn1_lanes", cuda_knn.pack_bias_target,
                   lambda packed, q: cuda_knn.nn1_lanes_prepped(packed, q, 32)),
    "v2-lanes8-simple": ("nn1_lanes_simple", raw_target, lambda tm, q: cuda_knn.nn1_lanes_simple(*tm, q, 8)),
    "v2-lanes32-simple": ("nn1_lanes_simple", raw_target, lambda tm, q: cuda_knn.nn1_lanes_simple(*tm, q, 32)),
    "v3-unroll2": ("nn1_unroll2", cuda_knn.pack_bias_target,
                   lambda packed, q: cuda_knn.nn1_unroll2_prepped(packed, q)),
    "v3-unroll2-simple": ("nn1_unroll2_simple", raw_target, lambda tm, q: cuda_knn.nn1_unroll2_simple(*tm, q)),
}

# The ring's forms at every query tile x chunk: label -> as INSTANCES. The
# tile is queries a block, or for a lane form (query, lane) slots a block.
_FORMS = (("v1-bias", "nn1_bias", cuda_knn.pack_bias_target, cuda_knn.nn1_bias_prepped, "queries"),
          *((f"v2-lanes{lanes}", "nn1_lanes", cuda_knn.pack_bias_target,
             functools.partial(cuda_knn.nn1_lanes_prepped, lanes=lanes), "slots") for lanes in cuda_knn.NN1_LANES),
          ("v3-unroll2", "nn1_unroll2", cuda_knn.pack_bias_target, cuda_knn.nn1_unroll2_prepped, "queries"),
          ("tiled", "nn1_tiled", cuda_knn.pack_target, cuda_knn.nn1_tiled_prepped, "queries"))
SWEEP = {
    f"{form} {tile}={qt} chunk={tc}": (key, pack, functools.partial(fn, query_tile=qt, chunk=tc))
    for form, key, pack, fn, tile in _FORMS for qt in cuda_knn.NN1_QUERY_TILES_STUDY for tc in cuda_knn.NN1_TILES
}


def _inf_target(t, m):
    """The library call's target: masked rows at +inf."""
    return torch.where(m.bool()[:, None], t, torch.inf).contiguous()


# Timed by --sweep after the kernels, in turns of their own, not held to
# nn1_plain: name -> (the target's preparation on (targets, mask), made once
# a shape and not timed, the call on (prepared target, queries)). The
# library call gives distances, not their squares.
YARDSTICKS = {
    "plain": (raw_target, lambda tm, q: cuda_knn.nn1_plain(*tm, q)),
    "cdist+min": (_inf_target, lambda t_inf, q: torch.cdist(
        q, t_inf, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)),
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


def in_turns(calls: dict, turns: int, device) -> dict:
    """The median of ``turns`` marginal times of each call, taken in turns:
    every call in order, then in reverse order, and so on (one pass in order
    for ``turns`` = 1)."""
    order = list(calls)
    times = {name: [] for name in order}
    for turn in range(turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            times[name].append(marginal_ms(calls[name], device))
    return {name: statistics.median(v) for name, v in times.items()}


def run_study(instances: dict, shapes, mask_every: int, device, turns: int = 1, yardsticks=None) -> list[dict]:
    """Each instance at each (Q, M), its target prepared once, held against
    ``nn1_plain`` (``agree``, ``dmax``) and against the first instance
    (``agree_v0``); then timed in turns (:func:`in_turns`), and after them
    the ``yardsticks`` (name -> (preparation, call), timed only, in turns of
    their own so that their heavy calls sit beside no kernel; their rows
    carry no ``agree``). Each row carries the shape's bound (``bound_ms``)."""
    rng = np.random.default_rng(0)
    yardsticks = yardsticks or {}
    rows = []
    for Q, M in shapes:
        t, m, q = study_inputs(rng, Q, M, mask_every, device)
        b_ms, b_by = nn1_bound(Q, M, int(m.sum()))
        print(f"Q={Q} M={M} (valid {int(m.sum())}): bound {b_ms:.4g} ms ({b_by})", flush=True)
        plain = cuda_knn.nn1_plain(t, m, q)
        first, calls, checks = None, {}, {}
        for name, (_, prepare, fn) in instances.items():
            target = prepare(t, m)
            idx, d2 = fn(target, q)
            if first is None:
                first = idx
            agree, dmax = agreement(idx, d2, *plain)
            checks[name] = {"agree": agree, "dmax": dmax, "agree_v0": float((idx == first).double().mean())}
            calls[name] = functools.partial(fn, target, q)
        times = in_turns(calls, turns, device)
        times.update(in_turns({name: functools.partial(fn, prepare(t, m), q)
                               for name, (prepare, fn) in yardsticks.items()}, turns, device))
        for name, ms in times.items():
            rows.append({"Q": Q, "M": M, "name": name, "ms": ms, "bound_ms": b_ms, **checks.get(name, {})})
            check = checks.get(name)
            tail = ("timed only" if check is None else f"idx_agree(plain)={check['agree']:.4f} "
                    f"dmax(plain)={check['dmax']:.2e} idx_agree(v0)={check['agree_v0']:.4f}")
            print(f"Q={Q} M={M} {name}: {ms:8.4f} ms ({Q / ms / 1e3:8.1f} Mq/s) {tail}", flush=True)
    return rows


def fastest(rows: list[dict], instances: dict) -> dict:
    """{(Q, M): {design: (label, ms)}}: each design's fastest instance at each
    shape, a design being a label's first word (``v2-lanes8`` and the sweep's
    ``v2-lanes8 queries=... chunk=...`` are one)."""
    best = {}
    for r in rows:
        if r["name"] not in instances:
            continue
        key = r["name"].split()[0]
        shape = best.setdefault((r["Q"], r["M"]), {})
        if key not in shape or r["ms"] < shape[key][1]:
            shape[key] = (r["name"], r["ms"])
    return best


def main(shapes=SHAPES, device: torch.device | str = "cuda", sweep: bool = False) -> list[dict]:
    """Run the variant study on ``device`` (the card unless the caller asks
    for the CPU), with ``sweep`` every ring instance and the yardsticks too;
    returns one row per (Q, M, instance)."""
    instances = {**INSTANCES, **SWEEP} if sweep else INSTANCES
    rows = run_study(instances, shapes, MASK_EVERY, require_device(device), TURNS,
                     YARDSTICKS if sweep else None)
    if sweep:
        for (Q, M), best in fastest(rows, instances).items():
            print(f"Q={Q} M={M} fastest: " + ", ".join(f"{label} {ms:.4f} ms" for label, ms in best.values()),
                  flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true", help="every ring instance, the plain and library calls")
    main(sweep=parser.parse_args().sweep)
