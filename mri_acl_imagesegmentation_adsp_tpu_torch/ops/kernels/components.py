"""Exact 4-connected component labels of a ``(S, H, W)`` mask stack, and the
masked 4-neighbour max propagation that probes for them.

Replaces the TPU kernel ``_prop_kernel`` (``scripts/probe_pallas_roll.py``,
the ``pallas_call`` of ``prop_pallas`` at :48-55) with the hand-written CUDA
kernels of ``csrc/label_prop.cu``; see that file for their design and what
bounds them. Their launch geometry is worked out here (:func:`tile_plan`,
:func:`prop_plan`), where the CPU tests reach it. Two entry points:

- :func:`masked_max_prop` is the probe's function exactly (wrap-around
  included); its plain version :func:`masked_max_prop_reference` is the
  probe's ``prop_xla`` loop (:59-65) in PyTorch.
- :func:`label_components` gives the labels of ``label_components`` in
  ``mri_acl_imagesegmentation_adsp_tpu/ops/maskops.py:195-262``, on the
  card by union-find over 32x32 tiles in three kernels. Its plain version
  :func:`label_components_reference` is that probe's step run to the
  fixpoint without wrap-around, as row and column sweeps of segmented
  minima until no label changes; it also counts the sweeps each slice
  takes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of each wrapper's CUDA work in this process: a wrapper adds one
# where it launches, and nowhere else, so a run can show its path went
# through it.
LAUNCHES = {"label_components": 0, "masked_max_prop": 0}

TILE = 32              # kTile in csrc/label_prop.cu: tiles of TILE x TILE
LINEAR_THREADS = 256   # kLinearThreads: a block of cc_merge, cc_compress
MAX_GRID_Y = 65535     # CUDA's limit on gridDim.y: slices beyond it loop
PROP_THREADS = 1024    # kPropThreads: a block of masked_max_prop
PROP_PIXELS_PER_THREAD = 32   # a thread's pixels are bits of one register
MAX_SMEM = 227 * 1024  # shared memory a block of an H100 can have
# The cluster's blocks (kCluster; 16 is a non-portable size) and the most
# halo rows a side (steps between cluster barriers): the fastest of 8 or 16
# blocks and 1-16 rows at the probe's 320x320 and 128 steps (PERF.md).
PROP_CLUSTER = 16
PROP_HALO = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile_plan(s: int, h: int, w: int) -> dict:
    """The launch geometry of ``label_components_u8`` for an ``(s, h, w)``
    stack. ``cc_local`` runs one block per tile: tile ``i`` of a slice
    covers rows ``[32 (i // tiles_x), +32)`` and columns ``[32 (i %
    tiles_x), +32)``, cut at the image's edge. ``cc_merge`` has ``border``
    items a slice: the ``(tiles_y - 1) * w`` pixels on the top rows of the
    tiles below the first tile row, then the ``(tiles_x - 1) * h`` on the
    left columns of the tiles right of the first. ``cc_compress`` takes
    the ``h * w`` pixels of a slice four a thread. The two run
    ``merge_blocks`` and ``compress_blocks`` blocks of ``LINEAR_THREADS``
    along a slice, enough for one item (or four pixels) a thread, at least
    one block (a slice of one tile has no border); every kernel runs
    ``grid_y`` blocks along the slices."""
    tiles_y, tiles_x = -(-h // TILE), -(-w // TILE)
    border = (tiles_y - 1) * w + (tiles_x - 1) * h
    return {"tiles_y": tiles_y, "tiles_x": tiles_x, "border": border,
            "merge_blocks": max(1, -(-border // LINEAR_THREADS)),
            "compress_blocks": -(-(h * w) // (4 * LINEAR_THREADS)),
            "grid_y": min(s, MAX_GRID_Y)}


def prop_plan(h: int, w: int) -> dict:
    """The launch geometry of ``masked_max_prop_f32`` for an ``(h, w)``
    image: block ``r`` of the cluster's ``PROP_CLUSTER`` owns rows ``[r *
    band, (r + 1) * band)`` cut at ``h`` (so the last blocks may own none),
    with ``min(PROP_HALO, band)`` halo rows a side; its shared memory holds
    two buffers of ``band + 2 * halo`` rows and two export areas of ``2 *
    halo`` rows. Raises ``ValueError`` where one cluster cannot hold the
    image: more than ``MAX_SMEM`` bytes, or more than 32 pixels a thread."""
    band = -(-h // PROP_CLUSTER)
    halo = min(PROP_HALO, band)
    smem = 4 * (2 * (band + 2 * halo) + 4 * halo) * w
    if (smem > MAX_SMEM
            or (band + 2 * halo) * w > PROP_PIXELS_PER_THREAD * PROP_THREADS):
        raise ValueError(f"masked_max_prop: a {h}x{w} image does not fit "
                         f"one cluster of {PROP_CLUSTER} blocks ({smem} bytes "
                         f"of shared memory a block with {halo} halo rows)")
    return {"cluster": PROP_CLUSTER, "band": band, "halo": halo,
            "smem": smem}


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


def label_components_reference(mask: torch.Tensor,
                               return_sweeps: bool = False):
    """Plain version of :func:`label_components`: run ids come from a
    ``cumsum`` of the background along an axis, per-run minima from
    ``scatter_reduce(..., "amin")``, and row and column sweeps alternate
    until no label changes (one host sync a sweep). The JAX version's fixed
    sweep count and its ``cc_ok`` certificate only bound XLA compiles; the
    partition and the labels are the same.

    With ``return_sweeps`` it returns ``(labels, sweeps)``, ``sweeps`` an
    ``(S,)`` int32 tensor of the sweeps each slice takes, the last of them
    the one that changes nothing: a measure of how far a mask's minima
    travel, which the kernel does not need."""
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
    sweeps = torch.ones(s, dtype=torch.int32, device=dev)
    while True:
        nxt = _run_min(lbl, row_id, fg, s * h * (w + 1), sentinel)
        nxt = _run_min(nxt, col_id, fg, s * w * (h + 1), sentinel)
        if torch.equal(nxt, lbl):
            return (lbl, sweeps) if return_sweeps else lbl
        if return_sweeps:
            sweeps += (nxt != lbl).flatten(1).any(dim=1).to(torch.int32)
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.label_components_u8.argtypes = [ptr, ptr] + [i32] * 9 + [ptr]
    lib.label_components_u8.restype = i32
    lib.masked_max_prop_f32.argtypes = [ptr, ptr, ptr] + [i32] * 5 + [
        ctypes.c_longlong, ptr]
    lib.masked_max_prop_f32.restype = i32
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of each slice of a ``(S, H, W)`` mask,
    nonzero meaning foreground.

    Returns int32 ``(S, H, W)``: background holds ``H*W``, each foreground
    pixel the minimum in-slice linear index of its component. A CUDA tensor
    goes to the kernels (or the call raises): three launches on the current
    stream, none of them waiting on the host. A CPU tensor goes to
    :func:`label_components_reference`."""
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
    if s == 0:
        return out
    plan = tile_plan(s, h, w)
    lib = load_library()
    with torch.cuda.device(mask.device):
        rc = lib.label_components_u8(
            m.data_ptr(), out.data_ptr(), s, h, w, plan["tiles_y"],
            plan["tiles_x"], plan["border"], plan["merge_blocks"],
            plan["compress_blocks"], plan["grid_y"], _stream(m))
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
    all steps in one launch (or the call raises, also ``ValueError`` for an
    image one cluster of blocks cannot hold); a CPU pair goes to
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
    plan = prop_plan(h, w)
    lib = load_library()
    mask, x = mask.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.masked_max_prop_f32(
            mask.data_ptr(), x.data_ptr(), out.data_ptr(), h, w, int(iters),
            plan["band"], plan["halo"], plan["smem"], _stream(x))
    if rc != 0:
        raise RuntimeError(f"masked_max_prop_f32 launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["masked_max_prop"] += 1
    return out
