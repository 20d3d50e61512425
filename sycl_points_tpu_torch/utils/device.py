"""Device selection helper.

Counterpart of :mod:`sycl_points_tpu.utils.device`: the reference selects
SYCL devices by vendor and type strings (``utils/sycl_utils.hpp:398-465``
device_selector in fateshelled/sycl_points). Here the candidates are the
visible CUDA cards and the CPU, described by ``torch.cuda``.

The JAX package's ``utils/compile_cache.py`` has no counterpart: eager
PyTorch compiles no programs, and the kernels' shared library is cached
under ``_build/``, keyed by a hash of its sources and flags
(``ops/cuda_knn.build_library``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _devices() -> list:
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if torch.cuda.is_available() else []
    return cards + [torch.device("cpu")]


def _describe(d: torch.device) -> str:
    if d.type == "cuda":
        return f"gpu cuda nvidia {torch.cuda.get_device_name(d)}"
    return "cpu"


def select_device(vendor: str = "", type: str = "") -> torch.device:
    """The first device whose description holds every word of ``vendor``
    and ``type`` (case-insensitive: "nvidia", "gpu", "cuda", "cpu", or words
    of the card's name); without a match or a request, a card before the
    CPU."""
    devs = _devices()
    want = f"{vendor} {type}".strip().lower()
    if want:
        for d in devs:
            hay = _describe(d).lower()
            if all(tok in hay for tok in want.split()):
                return d
    return devs[0]


def device_info(device: Optional[torch.device] = None) -> dict:
    """Platform, kind and index of ``device`` (default: the first of
    :func:`select_device`), and for a card its capability, memory and the
    count of visible cards."""
    d = torch.device(device) if device is not None else select_device()
    if d.type != "cuda":
        return {"platform": "cpu", "device_kind": "cpu", "id": 0, "count": 1}
    props = torch.cuda.get_device_properties(d)
    return {
        "platform": "gpu",
        "device_kind": props.name,
        "id": d.index if d.index is not None else torch.cuda.current_device(),
        "count": torch.cuda.device_count(),
        "capability": f"{props.major}.{props.minor}",
        "multi_processors": props.multi_processor_count,
        "bytes_limit": props.total_memory,
        "bytes_in_use": torch.cuda.memory_allocated(d),
    }


def print_device_info() -> None:
    for d in _devices():
        print(device_info(d))
