"""The correspondence search's share of its roofline: the least time of the
``nn1_batched`` launches of the traced slice (``port_bench/roofline.py``)
over the device time of their kernels (``knn_cluster_kernel<1, ...>``)."""

from port_bench.roofline import share_pct


def read(run):
    t = run.trace
    return share_pct(t.get("least_s", {}).get("nn1"), t.get("class_s", {}).get("nn1")) if t else None
