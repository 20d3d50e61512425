"""Batching of many odometry streams on one card (counterpart of
:mod:`sycl_points_tpu.parallel`): :class:`~.fleet.FleetOdometry`."""
