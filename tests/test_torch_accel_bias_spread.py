"""The accel-bias recovery of both packages' LIO under several sampling keys.

On the 3-D-excited figure-8 at 512 x 32 with the JAX bias record's biases
(``benchmarks/bench_lio_replay.py --excite3d --gyro-bias=0.02,-0.01,0.015
--accel-bias=0.05,0.03,-0.04 --gyro-bias-rw 1e-4 --accel-bias-rw 1e-3
--rings 32 --az 512``, 150 frames), the share of the injected bias each
package recovers depends on which points its samplers draw. This module
runs the JAX benchmark unchanged, with the instance's sampler keys replaced
after construction (:func:`reseeded_jax_lio`), and the port's
``run_lio_replay(seed=)`` on the same inputs, so the two spreads can be
compared:

    JAX_PLATFORMS=cpu python tests/test_torch_accel_bias_spread.py --package jax --seeds own 1 2 3
    PYTHONPATH=. python tests/test_torch_accel_bias_spread.py --package torch --seeds own 1 2 3

Each run prints one JSON line: the package, the seed, the final gyro and
accel bias errors, the shares recovered and the ATE. As a test module it
checks the reseeding itself, at a size that takes seconds.
"""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np

GYRO_BIAS = (0.02, -0.01, 0.015)
ACCEL_BIAS = (0.05, 0.03, -0.04)
BENCH_ARGS = ["--excite3d", "--gyro-bias=0.02,-0.01,0.015", "--accel-bias=0.05,0.03,-0.04",
              "--gyro-bias-rw", "1e-4", "--accel-bias-rw", "1e-3", "--rings", "32", "--az", "512"]


def reseed_jax(odo, seed) -> None:
    """Replace the three sampler keys of a JAX ``LidarInertialOdometry``
    (the scan's random downsampling, the registration sampling, the submap's
    sampling) with keys made from ``seed``; ``None`` keeps the package's."""
    import jax

    if seed is None:
        return
    odo.pc_processor._key = jax.random.key(3 * seed)
    odo._key = jax.random.key(3 * seed + 1)
    odo.submap._key = jax.random.key(3 * seed + 2)


def reseeded_jax_lio(seed):
    """A subclass of the JAX ``LidarInertialOdometry`` whose instances are
    reseeded by :func:`reseed_jax` right after construction."""
    from sycl_points_tpu.pipeline.lidar_inertial_odometry import LidarInertialOdometry

    class Reseeded(LidarInertialOdometry):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            reseed_jax(self, seed)

    return Reseeded


def run_jax(seed, frames: int) -> dict:
    """``bench_lio_replay.main()`` with :data:`BENCH_ARGS`, its odometry
    class swapped for :func:`reseeded_jax_lio`; returns its JSON line."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    import bench_lio_replay

    bench_lio_replay.LidarInertialOdometry = reseeded_jax_lio(seed)
    argv, out = sys.argv, io.StringIO()
    sys.argv = ["bench_lio_replay.py", *BENCH_ARGS, "--frames", str(frames)]
    try:
        with contextlib.redirect_stdout(out):
            bench_lio_replay.main()
    finally:
        sys.argv = argv
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    return {"gyro_bias_err": rec["gyro_bias_final_err"], "accel_bias_err": rec["accel_bias_final_err"],
            "ate_m": rec["ate_translation_m"]}


def run_torch(seed, frames: int) -> dict:
    """The port's ``run_lio_replay`` on the same replay, on the CPU;
    ``seed`` as its ``seed=`` (``None``: the package's seeds)."""
    from sycl_points_tpu_torch.apps import lio_replay

    inp = lio_replay.make_lio_inputs(frames, 512, 32, excite3d=True, gyro_bias=GYRO_BIAS, accel_bias=ACCEL_BIAS,
                                     device="cpu")
    out = lio_replay.run_lio_replay(lio_replay.lio_params(inp.poses[0], gyro_bias_rw=1e-4, accel_bias_rw=1e-3),
                                    inp, device="cpu", seed=seed)
    return {"gyro_bias_err": out["gyro_bias_err"], "accel_bias_err": out["accel_bias_err"], "ate_m": out["ate_m"]}


def recovered(err: float, injected) -> float:
    """The share of the injected bias recovered: ``1 - |error| / |injected|``."""
    return 1.0 - err / float(np.linalg.norm(injected))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--seeds", nargs="+", default=["own"], help="'own' (the package's seeds) or integers")
    ap.add_argument("--frames", type=int, default=150)
    args = ap.parse_args(argv)
    run = run_jax if args.package == "jax" else run_torch
    for s in args.seeds:
        seed = None if s == "own" else int(s)
        rec = run(seed, args.frames)
        rec.update(package=args.package, seed=s, frames=args.frames,
                   gyro_recovered=recovered(rec["gyro_bias_err"], GYRO_BIAS),
                   accel_recovered=recovered(rec["accel_bias_err"], ACCEL_BIAS))
        print(json.dumps(rec), flush=True)


def test_reseed_jax_replaces_the_three_sampler_keys():
    """A reseeded JAX instance draws from keys of its seed: all three differ
    from the package's and from another seed's, one seed gives the same
    keys twice, and ``None`` keeps the package's keys."""
    import jax

    from sycl_points_tpu.pipeline.params import LidarInertialOdometryParams

    def keys(seed):
        odo = reseeded_jax_lio(seed)(LidarInertialOdometryParams())
        return [np.asarray(jax.random.key_data(k)) for k in (odo.pc_processor._key, odo._key, odo.submap._key)]

    own, a, a2, b = keys(None), keys(1), keys(1), keys(2)
    for k_own, k_a, k_a2, k_b in zip(own, a, a2, b, strict=True):
        np.testing.assert_array_equal(k_a, k_a2)
        assert not np.array_equal(k_a, k_own)
        assert not np.array_equal(k_a, k_b)
    assert len({k.tobytes() for k in a}) == 3


def test_recovered_share():
    """``recovered``: no error is all of it, an error as large as the bias is none."""
    assert recovered(0.0, ACCEL_BIAS) == 1.0
    assert abs(recovered(float(np.linalg.norm(ACCEL_BIAS)), ACCEL_BIAS)) < 1e-12


if __name__ == "__main__":
    main()
