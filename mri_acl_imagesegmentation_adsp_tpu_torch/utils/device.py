"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    The port never falls back from the card to the CPU: a caller that asks
    for ``cuda`` on a machine without one gets an error, not a slow run.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def f32_on_card(dev: torch.device) -> Iterator[None]:
    """On a card, run f32 convolutions and matmuls in f32 inside the block;
    torch's defaults would run them in TF32. Serving and batch inference
    use it, so that their results are the CPU's up to rounding. The two
    flags are process-wide: on leaving the block they are put back as they
    were found, so the caller's process keeps its own settings."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
