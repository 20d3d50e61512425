"""The share of the traced slice in which no kernel, copy or set ran on the
card: 100 (1 - busy / window), busy the union of a card's intervals,
averaged over the cards the cell uses."""


def read(run):
    t = run.trace
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
