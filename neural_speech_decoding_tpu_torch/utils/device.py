"""Device selection and float32 matmul precision shared by the port's
entry points.

The entry points run on CUDA unless the caller names another device. With
no CUDA and no explicit device they raise: nothing falls back to the CPU
silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the current CUDA device; otherwise `torch.device(device)`.
    Raises RuntimeError when CUDA is asked for (or implied) and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions: the JAX package runs every
    matmul at Precision.HIGHEST, and TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not disable TF32")
