"""Batching of many odometry streams (counterpart of
:mod:`sycl_points_tpu.parallel`): :class:`~.fleet.FleetOdometry` and
:class:`~.fleet.FleetLIO` on one device or split over a mesh of devices
(``mesh=``), and :mod:`.sharded`, which splits one pair, a query batch or a
batch of pairs."""
