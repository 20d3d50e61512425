"""The study kernels' counterparts against the TPU studies, on the CPU.

The TPU tile sweep (``scripts/bench_pallas_tiles.py``, ``make_nn1``) and the
variant study (``scripts/bench_nn1_variants.py``, v0-v3) are loaded from
their files; on the loaded module objects only, ``pl`` is replaced by a
namespace whose ``pallas_call`` runs in interpret mode. The same seeded
numpy inputs (M=3000 targets with every 37th masked, Q=700 queries, uniform
+-50 m) go through each Pallas kernel and the port's wrapper, which runs
``nn1_plain`` for CPU tensors.

Tolerances: indices equal except where the two distances are tied within
1e-6; distances within atol=1e-5 (both sides are exact f32 difference-form
distances; a probe measured 7.6e-6 at this size).

With every target masked the port keeps ``pallas_knn.nn1_pallas``'s
semantics (idx 0, d2 = +inf). The TPU studies do not: they lack its mapping
of d >= 3e38 to inf and return d = 3e38, and v2 also returns idx 2**31 - 1.
``test_all_masked`` states both.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import np_

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants

ROOT = Path(__file__).resolve().parents[1]
M, Q, MASK_EVERY = 3000, 700, 37
TIE = 1e-6
D_ATOL = 1e-5
BIG = 3.0e38


def _load_study(name: str):
    spec = importlib.util.spec_from_file_location(f"tpu_study_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{**vars(pl), "pallas_call": functools.partial(pl.pallas_call, interpret=True)})
    return mod


@pytest.fixture(scope="module")
def studies():
    return types.SimpleNamespace(tiles=_load_study("bench_pallas_tiles"), variants=_load_study("bench_nn1_variants"))


def _inputs(seed: int, mask_every: int = MASK_EVERY):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-50, 50, (M, 3)).astype(np.float32)
    mask = np.ones(M, bool)
    if mask_every:
        mask[::mask_every] = False
    q = rng.uniform(-50, 50, (Q, 3)).astype(np.float32)
    return t, mask, q


# (TPU kernel on the loaded studies, the port's wrapper)
CASES = {
    "v0(1024,2048) / nn1": (lambda s: s.variants.make_v0(1024, 2048), cuda_knn.nn1),
    "v1(1024,2048) / nn1_bias": (lambda s: s.variants.make_v1(1024, 2048), cuda_knn.nn1_bias),
    "v2(512,1024) / nn1_lanes 8": (lambda s: s.variants.make_v2(512, 1024),
                                   functools.partial(cuda_knn.nn1_lanes, lanes=8)),
    "v2(512,1024) / nn1_lanes 32": (lambda s: s.variants.make_v2(512, 1024),
                                    functools.partial(cuda_knn.nn1_lanes, lanes=32)),
    "v3(512,1024) / nn1_unroll2": (lambda s: s.variants.make_v3(512, 1024), cuda_knn.nn1_unroll2),
    "make_nn1(1024,512) / nn1_tiled 128x2048": (lambda s: s.tiles.make_nn1(1024, 512),
                                                functools.partial(cuda_knn.nn1_tiled, threads=128, tile=2048)),
    "make_nn1(1024,512) / nn1_tiled 64x512": (lambda s: s.tiles.make_nn1(1024, 512),
                                              functools.partial(cuda_knn.nn1_tiled, threads=64, tile=512)),
    "make_nn1(1024,512) / nn1_tiled 512x4096": (lambda s: s.tiles.make_nn1(1024, 512),
                                                functools.partial(cuda_knn.nn1_tiled, threads=512, tile=4096)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_tpu_study(studies, case):
    make_tpu, port = CASES[case]
    t, mask, q = _inputs(seed=len(case))
    ji, jd = make_tpu(studies)(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(q))
    ti, td = port(torch.from_numpy(t), torch.from_numpy(mask), torch.from_numpy(q))
    ji, jd = torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jd))
    assert cuda_knn.nn1_mismatches(ti, td, ji, jd, TIE) == 0
    np.testing.assert_allclose(np_(td), np_(jd), rtol=0, atol=D_ATOL)
    assert bool(torch.from_numpy(mask)[ti.long()].all())


ALL_MASKED = {  # TPU kernel, the index it returns when no target is valid
    "v0": (lambda s: s.variants.make_v0(1024, 2048), 0),
    "v1": (lambda s: s.variants.make_v1(1024, 2048), 0),
    "v2": (lambda s: s.variants.make_v2(512, 1024), 2**31 - 1),
    "v3": (lambda s: s.variants.make_v3(512, 1024), 0),
    "make_nn1": (lambda s: s.tiles.make_nn1(1024, 512), 0),
}


@pytest.mark.parametrize("kernel", sorted(ALL_MASKED))
def test_all_masked(studies, kernel):
    make_tpu, tpu_idx = ALL_MASKED[kernel]
    t, _, q = _inputs(seed=5)
    none = np.zeros(M, bool)
    ji, jd = make_tpu(studies)(jnp.asarray(t), jnp.asarray(none), jnp.asarray(q))
    # the TPU studies' traits: d = 3e38, not inf; v2 also idx 2**31 - 1
    assert np.all(np.asarray(jd) == np.float32(BIG)) and np.all(np.asarray(ji) == tpu_idx)
    # the port keeps nn1_pallas's semantics for every wrapper
    args = (torch.from_numpy(t), torch.from_numpy(none), torch.from_numpy(q))
    for port in (cuda_knn.nn1, cuda_knn.nn1_bias, cuda_knn.nn1_unroll2,
                 functools.partial(cuda_knn.nn1_lanes, lanes=8),
                 functools.partial(cuda_knn.nn1_tiled, threads=256, tile=1024)):
        ti, td = port(*args)
        assert bool((ti == 0).all()) and bool(torch.isinf(td).all())


def test_wrappers_reject_instances_not_built():
    t, mask, q = (torch.from_numpy(a) for a in _inputs(seed=6))
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled(t, mask, q, threads=96, tile=2048)
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled(t, mask, q, threads=128, tile=8192)
    with pytest.raises(ValueError):
        cuda_knn.nn1_lanes(t, mask, q, lanes=16)
    with pytest.raises(ValueError):
        cuda_knn.nn1_bias(t[:, :2].contiguous(), mask, q)


@pytest.mark.parametrize("study,n_instances", [(bench_nn1_tiles, 16), (bench_nn1_variants, 5)])
def test_study_entry_points_on_the_cpu(study, n_instances):
    shapes = ((70, 300), (33, 1100))
    rows = study.main(shapes=shapes, device="cpu")
    assert len(rows) == n_instances * len(shapes)
    assert all(r["agree"] == 1.0 and r["dmax"] == 0.0 and r["agree_v0"] == 1.0 for r in rows)
    assert [(r["Q"], r["M"]) for r in rows[::n_instances]] == list(shapes)


def test_study_inputs_follow_the_tpu_scripts():
    """Targets, then queries, from default_rng(0), uniform +-50 m."""
    rng = np.random.default_rng(0)
    t, m, q = bench_nn1_variants.study_inputs(np.random.default_rng(0), 40, 100, MASK_EVERY, torch.device("cpu"))
    np.testing.assert_array_equal(np_(t), rng.uniform(-50, 50, (100, 3)).astype(np.float32))
    np.testing.assert_array_equal(np_(q), rng.uniform(-50, 50, (40, 3)).astype(np.float32))
    assert np_(m).tolist() == [0 if i % MASK_EVERY == 0 else 1 for i in range(100)]
