"""Prefix sums and stream compaction on the device.

Counterpart of :mod:`sycl_points_tpu.ops.prefix_sum` (the reference's
work-group scan and ``FilterByFlags::calculate_indices``): a device-wide scan
is one ``torch.cumsum``; these helpers package the compaction idioms built on
it. Integer and boolean inputs scan in int32, as the JAX package's do.
"""

from __future__ import annotations

import torch


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, -1, dtype=x.dtype if x.is_floating_point() else torch.int32)


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    c = inclusive_scan(x)
    return c - x.to(c.dtype)


def compaction_offsets(flags: torch.Tensor):
    """``(offsets, count)``: each kept element's output position and the
    kept count (a 0-dim device tensor)."""
    f = flags.to(torch.int32)
    return exclusive_scan(f), f.sum(dtype=torch.int32)


def compaction_indices(flags: torch.Tensor) -> torch.Tensor:
    """The old -> new index map, -1 for removed elements."""
    offsets, _ = compaction_offsets(flags)
    return torch.where(flags.bool(), offsets, -1)


def scatter_compact(values: torch.Tensor, flags: torch.Tensor, out_size: int) -> torch.Tensor:
    """The kept rows of ``values`` at the front of a zeroed ``[out_size, ...]``
    output, in order; a row whose slot lies at or beyond ``out_size`` is
    dropped."""
    offsets, _ = compaction_offsets(flags)
    tgt = torch.where(flags.bool(), offsets, out_size).clamp_max(out_size).long()
    out = torch.zeros((out_size + 1,) + values.shape[1:], dtype=values.dtype, device=values.device)
    out.index_copy_(0, tgt, values)
    return out[:out_size]
