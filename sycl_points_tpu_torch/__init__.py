"""PyTorch + CUDA port of the scan-pair registration path of sycl_points_tpu.

The JAX package :mod:`sycl_points_tpu` is the reference: every module here has
its counterpart at the same relative path there. Plain tensor code is
PyTorch; the nearest-neighbour kernels are hand-written CUDA
(:mod:`sycl_points_tpu_torch.ops.cuda_knn`, ``csrc/knn.cu``).

Everything is float32. Reduced-precision products pick wrong neighbours on
LiDAR-scale coordinates, so TF32 is switched off for matmuls and cuDNN when
the package is imported.

Entry points run on the card unless the caller asks for the CPU; with no
card they raise (:func:`require_device`), and nothing falls back.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and no
    card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is False")
    return device
