"""The shadowing scenes of the Morton window's union, shared by its tests and
the smoke run.

JAX's union of the two window passes sorts the ``2 k`` entries ``[pass 1,
pass 2]`` by index and turns every later occurrence of an index into a 3e38
duplicate. A pass-1 padding entry (3e38, the index of the clipped partner at
sorted position 0 or N - 1) thus shadows a pass-2 neighbour of that index.
With finite distances no pass-1 row pads past a neighbour it holds, so the
case needs distances that overflow: these scenes put the points in cells of
:data:`SHADOW_CELL` metres, so that most window distances are +inf and each
pass's padding reaches its top k.
"""

from __future__ import annotations

import numpy as np

SHADOW_CELL = 1e19
# (window, points, valid, seed) of the shadowing scene at each k: a seed whose
# scene holds the case
SHADOW = {6: (8, 20, 16, 0), 20: (16, 48, 46, 2), 64: (48, 144, 142, 56)}


def shadow_scene(k: int):
    """Points ``[n, 3]`` f32 (numpy) in cells of :data:`SHADOW_CELL` metres
    (0..5 a axis), nearly all valid, their mask and the window: on these
    seeds a pass-1 padding entry shadows the same index in pass 2
    (:func:`shadowed`)."""
    window, n, n_valid, seed = SHADOW[k]
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 6, size=(n, 3))
    pts = ((cells + rng.uniform(0.05, 0.95, size=(n, 3))) * SHADOW_CELL).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_valid, replace=False)] = True
    return pts, mask, window


def shadowed(i1, d1, i2, d2) -> int:
    """(row, index) pairs where pass 1 holds the index only as padding (3e38)
    and pass 2 holds it at another value: the union makes that entry a 3e38
    duplicate. Takes numpy arrays or tensors on any device."""
    big = np.float32(3e38)
    i1, d1, i2, d2 = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (i1, d1, i2, d2))
    count = 0
    for r in range(i1.shape[0]):
        pad = {int(i) for i, d in zip(i1[r], d1[r]) if d == big}
        other = {int(i) for i, d in zip(i1[r], d1[r]) if d != big}
        count += sum(int(i) in pad and int(i) not in other for i, d in zip(i2[r], d2[r]) if d != big)
    return count
