"""Kernels on the cards a fleet frame in the traced slice (every card's, where
the fleet is split), the program's and PyTorch's (the benchmark's own
counting kernels left out)."""


def read(run):
    t = run.trace
    return t["launches"] / t["frames"] if t and t.get("frames") and t.get("launches") else None
