"""Host reads of device values, counted; host arrays to the device in one copy.

Every place in the package where the host waits for a value computed on the
device goes through :func:`to_host`, so a caller can report how many such
waits a piece of work cost (``LidarOdometry.sync_count_last_frame``), and
from where (:data:`by_source`, keyed by the calling ``file:line``). On the
card each one is a device-to-host copy that blocks until the stream has
drained; in eager PyTorch they stand where the JAX package has a
``lax.while_loop`` condition or a ``lax.cond``.

:class:`DeferredFetch` is the one read that does not block at once: the
counterpart of ``copy_to_host_async`` + ``jax.Array.is_ready``, which the
pipelined frames use for their per-frame stats.

The counts are exact under threads (a fleet split over devices reads from
one thread a shard), and each thread also counts its own
(:func:`thread_reads`). A thread may hold a host turn (:func:`set_host_turn`),
which it gives up while a read waits for the card (:func:`waiting`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from collections import Counter

import numpy as np
import torch

# Host reads since the last reset_sync_count(); ``blocking_fetches`` counts
# the DeferredFetch.get() calls that had to wait (each is a host read too).
counts = {"host_syncs": 0, "blocking_fetches": 0}
# Host reads since the last reset_sync_count(), by the file:line that asked.
by_source: Counter = Counter()
# The counts are updated under a lock: a fleet split over devices reads from
# one host thread a shard, and ``+=`` on a shared dict is not atomic.
_lock = threading.Lock()
_local = threading.local()


def reset_sync_count() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0
        by_source.clear()


def thread_reads() -> Counter:
    """The host reads made on the calling thread since it began, by
    ``file:line`` (never reset: a caller takes differences)."""
    reads = getattr(_local, "reads", None)
    if reads is None:
        reads = _local.reads = Counter()
    return reads


def _count(depth: int, blocking: bool = False) -> None:
    frame = sys._getframe(depth + 1)
    source = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    with _lock:
        counts["host_syncs"] += 1
        counts["blocking_fetches"] += blocking
        by_source[source] += 1
    thread_reads()[source] += 1


def set_host_turn(turn) -> None:
    """Give the calling thread a host turn: a lock it holds while it runs
    host work and gives up while it waits for the card (:func:`waiting`).
    The shards of a fleet split over devices share one, so that one shard
    launches while another waits, and their threads do not hand the GIL
    to each other at every torch call."""
    _local.turn = turn


@contextlib.contextmanager
def waiting():
    """A blocking wait of the calling thread: its host turn, if it has one,
    is given up for the wait and taken back after it."""
    turn = getattr(_local, "turn", None)
    if turn is None:
        yield
        return
    turn.release()
    try:
        yield
    finally:
        turn.acquire()


def to_host(value: torch.Tensor):
    """``value.tolist()`` (a Python scalar for a 0-dim tensor), counted as
    one host sync."""
    _count(1)
    if not value.is_cuda:
        return value.tolist()
    with waiting():
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


class DeferredFetch:
    """A device tensor on its way to the host.

    On the card the copy goes into a pinned host buffer without blocking (a
    copy into pageable memory would be synchronous), and a CUDA event recorded
    after it on the current stream says when the buffer holds the value:
    :meth:`ready` asks the event and never waits; :meth:`get` returns the
    value, and waits only if the copy has not landed, which it counts as one
    host sync and one blocking fetch. The buffer is not read before its event
    has completed. Streams are per thread, so a fetch is used only on the
    thread that made it.

    On the CPU the copy is made at once and :meth:`ready` is always true.
    """

    def __init__(self, value: torch.Tensor):
        self._thread = threading.get_ident()
        if value.device.type == "cuda":
            self._host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))
        else:
            self._host = value.detach().clone()
            self._event = None

    def _check_thread(self) -> None:
        if threading.get_ident() != self._thread:
            raise RuntimeError("a DeferredFetch is used on another thread than the one that made it")

    def ready(self) -> bool:
        """Whether :meth:`get` would return without waiting."""
        self._check_thread()
        return self._event is None or self._event.query()

    def get(self) -> np.ndarray:
        """The value on the host, as a numpy array."""
        if not self.ready():
            _count(1, blocking=True)
            with waiting():
                self._event.synchronize()
        return self._host.numpy()
