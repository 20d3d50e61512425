"""The covariance self-k-NN's share of its roofline: the least time of the
``knn_k_batched`` launches of the traced slice (``port_bench/roofline.py``)
over the device time of their kernels."""

from port_bench.roofline import share_pct


def read(run):
    t = run.trace
    return share_pct(t.get("least_s", {}).get("knn_k"), t.get("class_s", {}).get("knn_k")) if t else None
