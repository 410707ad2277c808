"""Least times of the body-mask kernels at a ``(S, H, W)`` uint8 stack, and
the names under which their CUDA kernels appear in a profiler trace.

Frozen copies of ``chip_smoke.py`` at commit 090937a:
``open_close_bound_ms`` (:440-451, with ``OPS_PER_WORD`` :324) and
``label_components_bound_ms`` (:1678-1689, with ``CC_OPS_PER_PIXEL``
:1672), in seconds. Each bound is the larger of the bytes the function
must move once over the card's bandwidth and its integer operations over
the INT32 rate. The kernel names are the ``__global__`` functions of the
port's ``csrc/open_close.cu`` and ``csrc/label_prop.cu`` that those
functions launch.
"""

from __future__ import annotations

from typing import Tuple

from .peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S

OPS_PER_WORD = 4 * (8 + 12)   # passes x (funnel shifts + AND/OR) a word
CC_OPS_PER_PIXEL = 12         # 4 neighbours x (test, min, index step)

OPEN_CLOSE_KERNELS = ("open_close_kernel",)
LABEL_KERNELS = ("cc_local_kernel", "cc_merge_kernel", "cc_compress_kernel")


def open_close_bytes(shape: Tuple[int, int, int]) -> int:
    """Each pixel read once and written once."""
    s, h, w = shape
    return 2 * s * h * w


def open_close_ops(shape: Tuple[int, int, int]) -> int:
    """INT32 operations of the bit-packed disk(2) open + close."""
    s, h, w = shape
    return OPS_PER_WORD * s * h * -(-w // 32)


def label_components_bytes(shape: Tuple[int, int, int]) -> int:
    """The uint8 mask read once and the int32 labels written once."""
    s, h, w = shape
    return 5 * s * h * w


def label_components_ops(shape: Tuple[int, int, int]) -> int:
    """One pass joining every pixel to its four neighbours."""
    s, h, w = shape
    return CC_OPS_PER_PIXEL * s * h * w


def _bound(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def open_close_bound_s(shape: Tuple[int, int, int]) -> float:
    return _bound(open_close_bytes(shape), open_close_ops(shape))


def label_components_bound_s(shape: Tuple[int, int, int]) -> float:
    return _bound(label_components_bytes(shape), label_components_ops(shape))


def mask_kernels_bound_s(shape: Tuple[int, int, int]) -> float:
    """Least time of one body mask's open/close and its labels."""
    return open_close_bound_s(shape) + label_components_bound_s(shape)
