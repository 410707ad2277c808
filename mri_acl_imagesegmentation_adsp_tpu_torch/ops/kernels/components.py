"""Exact 4-connected component labels of a ``(S, H, W)`` mask stack, and the
masked 4-neighbour max propagation that probes for them.

Replaces the TPU kernel ``_prop_kernel`` (``scripts/probe_pallas_roll.py``,
the ``pallas_call`` of ``prop_pallas`` at :48-55) with the hand-written CUDA
kernels of ``csrc/label_prop.cu``; see that file for their design and what
bounds them. Two entry points:

- :func:`masked_max_prop` is the probe's function exactly (wrap-around
  included); its plain version :func:`masked_max_prop_reference` is the
  probe's ``prop_xla`` loop (:59-65) in PyTorch.
- :func:`label_components` is that step run to the fixpoint without
  wrap-around, as segmented minima along rows and columns: the labels of
  ``label_components`` in ``mri_acl_imagesegmentation_adsp_tpu/ops/
  maskops.py:195-262``. Its plain version :func:`label_components_reference`
  alternates row and column sweeps until no label changes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of each CUDA kernel in this process: a wrapper adds one where it
# launches, and nowhere else, so a run can show its path went through it.
LAUNCHES = {"label_components": 0, "masked_max_prop": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _run_min(lbl: torch.Tensor, run_id: torch.Tensor, fg: torch.Tensor,
             n_runs: int, sentinel: int) -> torch.Tensor:
    """Replace each foreground label by the minimum over its run.

    Background pixels scatter their sentinel, which never lowers a minimum,
    so every pixel can scatter without first selecting the foreground."""
    mins = torch.full((n_runs,), sentinel, dtype=lbl.dtype, device=lbl.device)
    mins.scatter_reduce_(0, run_id.reshape(-1), lbl.reshape(-1), "amin")
    return torch.where(fg, mins[run_id], sentinel)


def label_components_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`label_components`: run ids come from a
    ``cumsum`` of the background along an axis, per-run minima from
    ``scatter_reduce(..., "amin")``, and row and column sweeps alternate
    until no label changes (one host sync a sweep). The JAX version's fixed
    sweep count and its ``cc_ok`` certificate only bound XLA compiles; the
    partition and the labels are the same."""
    s, h, w = mask.shape
    dev = mask.device
    fg = mask > 0
    bg = (~fg).to(torch.int64)
    sentinel = h * w
    lbl = torch.where(fg, torch.arange(h * w, dtype=torch.int32,
                                       device=dev).view(1, h, w),
                      sentinel).to(torch.int32)
    # a run of foreground along an axis is the pixels between two
    # background pixels: a cumsum of the background numbers the runs
    rows = torch.arange(s * h, device=dev).view(s, h, 1)
    row_id = rows * (w + 1) + torch.cumsum(bg, dim=2)
    cols = (torch.arange(s, device=dev).view(s, 1, 1) * w
            + torch.arange(w, device=dev).view(1, 1, w))
    col_id = cols * (h + 1) + torch.cumsum(bg, dim=1)
    while True:
        nxt = _run_min(lbl, row_id, fg, s * h * (w + 1), sentinel)
        nxt = _run_min(nxt, col_id, fg, s * w * (h + 1), sentinel)
        if torch.equal(nxt, lbl):
            return lbl
        lbl = nxt


def masked_max_prop_reference(mask: torch.Tensor, x: torch.Tensor,
                              iters: int) -> torch.Tensor:
    """Plain version of :func:`masked_max_prop`: ``iters`` steps of
    ``v = where(mask > 0, max(v, max of the 4 circular neighbours), v)``."""
    m = mask > 0
    v = x
    for _ in range(int(iters)):
        nb = torch.maximum(
            torch.maximum(torch.roll(v, 1, 0), torch.roll(v, -1, 0)),
            torch.maximum(torch.roll(v, 1, 1), torch.roll(v, -1, 1)))
        v = torch.where(m, torch.maximum(v, nb), v)
    return v


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def load_library() -> ctypes.CDLL:
    """Build and load ``csrc/label_prop.cu`` (once per process)."""
    lib = _build.load("label_prop")
    lib.label_components_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.label_components_u8.restype = ctypes.c_int
    lib.masked_max_prop_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.masked_max_prop_f32.restype = ctypes.c_int
    lib.masked_max_prop_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.masked_max_prop_smem.restype = ctypes.c_longlong
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def label_components(mask: torch.Tensor,
                     sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """4-connected component labels of each slice of a ``(S, H, W)`` mask,
    nonzero meaning foreground.

    Returns int32 ``(S, H, W)``: background holds ``H*W``, each foreground
    pixel the minimum in-slice linear index of its component. A CUDA tensor
    goes to the kernel (or the call raises), which runs to the fixpoint in
    one launch; a CPU tensor goes to :func:`label_components_reference`.
    ``sweeps``, an ``(S,)`` int32 CUDA tensor, receives the sweeps each slice
    took on the card (the last of them changed nothing)."""
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"mask must be a torch.Tensor, got {type(mask)}")
    if mask.dim() != 3:
        raise ValueError(f"mask must be (S, H, W), got {tuple(mask.shape)}")
    s, h, w = mask.shape
    if h < 1 or w < 1 or h * w >= 2 ** 31 - 1:
        raise ValueError(f"mask needs 1 <= H*W < 2**31 - 1, got "
                         f"{tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return label_components_reference(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    m = (mask if mask.dtype == torch.uint8 else (mask > 0).to(torch.uint8)
         ).contiguous()
    out = torch.empty((s, h, w), dtype=torch.int32, device=mask.device)
    if sweeps is not None and (sweeps.shape != (s,) or sweeps.dtype !=
                               torch.int32 or sweeps.device != mask.device):
        raise ValueError("sweeps must be an (S,) int32 tensor on the mask's "
                         "device")
    if s == 0:
        return out
    lib = load_library()
    with torch.cuda.device(mask.device):
        rc = lib.label_components_u8(
            m.data_ptr(), out.data_ptr(), s, h, w,
            None if sweeps is None else sweeps.data_ptr(), _stream(m))
    if rc != 0:
        raise RuntimeError(f"label_components_u8 launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["label_components"] += 1
    return out


def masked_max_prop(mask: torch.Tensor, x: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """``iters`` steps of ``v = where(mask > 0, max(v, max of the 4
    circular neighbours), v)`` from ``v = x``, for float32 ``(H, W)``
    tensors; returns a new float32 tensor. A CUDA pair goes to the kernel,
    all steps in one launch (or the call raises, also for an image one
    cluster of blocks cannot hold); a CPU pair goes to
    :func:`masked_max_prop_reference`."""
    for name, t in (("mask", mask), ("x", x)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
    if mask.dim() != 2 or mask.shape != x.shape or min(mask.shape) < 1:
        raise ValueError(f"mask and x must be one (H, W) shape, got "
                         f"{tuple(mask.shape)} and {tuple(x.shape)}")
    if mask.device != x.device:
        raise ValueError("mask and x must lie on one device")
    if int(iters) < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if mask.device.type == "cpu":
        return masked_max_prop_reference(mask, x, iters)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    h, w = mask.shape
    lib = load_library()
    if lib.masked_max_prop_smem(h, w) == 0:
        raise ValueError(f"masked_max_prop: a {h}x{w} image does not fit "
                         "the shared memory of one cluster")
    mask, x = mask.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.masked_max_prop_f32(mask.data_ptr(), x.data_ptr(),
                                     out.data_ptr(), h, w, int(iters),
                                     _stream(x))
    if rc != 0:
        raise RuntimeError(f"masked_max_prop_f32 launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["masked_max_prop"] += 1
    return out
