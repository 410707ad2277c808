"""Complex data at the host boundary, and the complex solve.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/ops/cpair.py``. The JAX
package computes on real ``(..., 2)`` pairs because the TPU has no complex
dtype; the port computes on complex tensors, so its ``cmul`` / ``cconj`` /
``cabs`` / ``cmatmul`` are torch's own ``*``, ``conj``, ``abs`` and
``matmul``. What stays:

- ``to_pair_np`` (from ``ops/fftc.py``) and ``to_complex``, the host
  conversions;
- ``to_pair_device``: a host array to a float32 ``(..., 2)`` pair on a
  device, uploading a C-contiguous complex64 buffer as it lies in memory
  (it is its own float32 pair), with no host copy; any reordering of axes
  is for the device to do;
- ``csolve``, the batched complex solve of the GRAPPA weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .fftc import to_pair_np

__all__ = ["to_pair_np", "to_complex", "to_pair_device", "csolve"]


def to_complex(x) -> np.ndarray:
    """A ``(..., 2)`` pair (numpy or tensor) or a complex tensor -> host
    complex64 ndarray."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_complex():
            return x.to(torch.complex64).numpy()
        x = x.numpy()
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def to_pair_device(x, transfer_dtype: Optional[str] = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Host complex or real array -> float32 ``(..., 2)`` pair on
    ``device``.

    A C-contiguous complex64 array goes up as its own float32 view: no
    host-side copy (the stacked re/im conversion of a 1.13 GB T2 case is
    seconds of single-threaded numpy). ``transfer_dtype="bfloat16"`` rounds
    the pair to bfloat16 on the host (round to nearest even), uploads half
    the bytes and upcasts to float32 on the device: a bandwidth-for-
    accuracy trade of about 0.4 % relative, not exact. Default None (or
    "float32") is exact."""
    if transfer_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unsupported transfer_dtype {transfer_dtype!r}")
    dev = resolve_device(device)
    x = np.asarray(x)
    if x.dtype == np.complex64 and x.flags.c_contiguous:
        host = torch.from_numpy(x.view(np.float32).reshape(*x.shape, 2))
    elif np.iscomplexobj(x):
        host = torch.from_numpy(to_pair_np(x))
    else:
        re = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        host = torch.stack([re, torch.zeros_like(re)], dim=-1)
    if transfer_dtype == "bfloat16":
        return host.to(torch.bfloat16).to(dev).float()
    return host.to(dev)


def csolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``X`` with ``A X = B`` for complex ``A`` ``(..., N, N)`` and ``B``
    ``(..., N, M)``, batched over the leading axes.

    The JAX version solves the real block embedding ``[[Ar, -Ai], [Ai,
    Ar]]``, twice the size; here the complex LU solves it directly. The two
    agree to within the conditioning of the system, not bit for bit."""
    return torch.linalg.solve(a, b)
