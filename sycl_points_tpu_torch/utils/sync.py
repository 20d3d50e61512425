"""Host reads of device values, counted; host arrays to the device in one copy.

Every place in the package where the host waits for a value computed on the
device goes through :func:`to_host`, so a caller can report how many such
waits a piece of work cost (``LidarOdometry.sync_count_last_frame``). On the
card each one is a device-to-host copy that blocks until the stream has
drained; in eager PyTorch they stand where the JAX package has a
``lax.while_loop`` condition or a ``lax.cond``.
"""

from __future__ import annotations

import numpy as np
import torch

# Host reads since the last reset_sync_count().
counts = {"host_syncs": 0}


def reset_sync_count() -> None:
    counts["host_syncs"] = 0


def to_host(value: torch.Tensor):
    """``value.tolist()`` (a Python scalar for a 0-dim tensor), counted as
    one host sync."""
    counts["host_syncs"] += 1
    return value.tolist()


def to_device(device: torch.device, *arrays) -> list:
    """Host arrays as float32 tensors on ``device``, each with its shape, made
    by one host-to-device copy (a frame's small host inputs travel
    together)."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    dev = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in arrays:
        shape = np.shape(a)
        n = int(np.prod(shape))
        out.append(dev[at : at + n].reshape(shape))
        at += n
    return out
