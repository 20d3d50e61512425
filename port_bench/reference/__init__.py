"""The plain reference that decides ``correct``: float64 PyTorch, no kernel,
no import of the program (``sycl_points_tpu_torch``) or of the JAX package.

Each stage that a run captures (:mod:`port_bench.capture`) is judged here
from the inputs the benchmark made and from the stage's own inputs:

- :mod:`.scan`: the preprocessed scan, from the raw scan (box filter, voxel
  centroids, robust neighbourhood covariances, the angle-of-incidence gate);
- :mod:`.gicp`: the registration's pose, refined to its fixed point;
- :mod:`.imu_lio`: the 15-DOF LiDAR-inertial solve, run again;
- :mod:`.voxel_map`: the submap step, the insert into the map the program
  held, the in-range extraction and the target's covariances.

Every function takes a ``dtype``: float64 is the reference; the control
(:mod:`port_bench.control`) runs the same functions in bfloat16.
"""
