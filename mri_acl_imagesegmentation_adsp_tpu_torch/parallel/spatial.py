"""Depth (halo-exchange) sharding of 3-D convolutions and of the whole 3-D
U-Net over ranks.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/parallel/spatial.py``:
``_exchange_depth_halos`` (:36-51), ``_validate`` (:89-106),
``conv3d_depth_sharded`` / ``conv3d_stack_depth_sharded`` (:109-135),
``make_depth_mesh`` (:146-152) and ``unet3d_depth_sharded_apply``
(:155-209). A volume ``(N, C, D, H, W)`` is cut along its depth into one
contiguous band a rank of a depth group; each rank keeps its band of every
activation, so a volume larger than one card's memory runs.

- :func:`exchange_depth_halos` is ``ppermute``'s halo exchange as one
  ``batch_isend_irecv`` of up to four ops (``parallel/mesh.py:exchange``):
  a rank sends its first ``after`` planes to the rank before it and its
  last ``before`` planes to the rank after it, and pads its band with what
  it receives; the first and last ranks pad with zeros, which is SAME's
  zero padding at the volume's ends. Its backward pass sends each halo's
  gradient back to the rank it came from, which adds it to its edge
  planes.
- :func:`conv3d_band` is a SAME conv3d of a band: the depth padding of the
  whole volume (:func:`same_pads`, shared with ``models/unet3d.py``)
  comes from the neighbours, then a depth-VALID conv runs on the padded
  band; H and W are padded locally. A 3x3x3 stride-1 conv takes one plane
  from each neighbour; a 3x3x3 stride-2 conv over an even depth, padded
  ``(0, 1)``, one plane from the next rank only, which is right where
  every band starts on an even plane; a 1x1x1 conv takes none.
- :func:`depth_bands` cuts a depth in units of ``2 ** (len(channels) -
  1)`` planes, so every band of every level of the U-Net starts on an even
  plane: whole units, the first ranks taking one more where the ranks do
  not divide them; with fewer units than ranks it returns None and the
  volume is replicated (every rank runs it whole, without collectives), as
  JAX's trainer replicates a depth its mesh does not divide.
- :func:`depth_sharded` sets a :class:`DepthBand` on a model's
  ``SameConv3d`` and ``InstanceNorm`` layers for a block (as
  ``models/norm.py:synced`` sets a group on BatchNorm): the convs then pad
  their band by :func:`conv3d_band` and the norms sum their statistics
  over the depth group. The block must hold the backward pass too where
  the model recomputes its units (``remat``): the recompute reruns the
  halo exchanges and the norm sums, every rank in the same order.
- :func:`unet3d_depth_sharded_apply` runs a whole volume through the 3-D
  U-Net with each rank on its band and returns the whole logits on every
  rank (one all-reduce of zero-filled buffers, exact).

Counts: every point-to-point send and its bytes go to
``parallel/mesh.py:P2P_COUNTS``.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh import (DataGroup, all_reduce_, exchange, make_recon_grid,
                   ReconGrid)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """``lax.padtype_to_pads`` for "SAME": (before, after) of one
    dimension of size ``n`` under kernel ``k`` and stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _DepthHalos(torch.autograd.Function):
    """The band padded with ``before`` planes from the rank before and
    ``after`` planes from the rank after (zeros at the volume's ends)."""

    @staticmethod
    def forward(ctx, x, before, after, group):
        r, n, d = group.rank, group.world, x.shape[2]
        ctx.meta = (before, after, group, d)
        sends, recvs = [], []
        if before and r + 1 < n:
            sends.append((x[:, :, d - before:], r + 1))
        if after and r > 0:
            sends.append((x[:, :, :after], r - 1))
        prev = x.new_zeros(x.shape[:2] + (before,) + x.shape[3:])
        nxt = x.new_zeros(x.shape[:2] + (after,) + x.shape[3:])
        if before and r > 0:
            recvs.append((prev, r - 1))
        if after and r + 1 < n:
            recvs.append((nxt, r + 1))
        got = exchange(sends, recvs, group)
        if before and r > 0:
            prev = got.pop(0)
        if after and r + 1 < n:
            nxt = got.pop(0)
        return torch.cat([prev, x, nxt], dim=2)

    @staticmethod
    def backward(ctx, g):
        before, after, group, d = ctx.meta
        r, n = group.rank, group.world
        gx = g[:, :, before:before + d].clone()
        sends, recvs = [], []
        if before and r > 0:
            sends.append((g[:, :, :before], r - 1))
        if after and r + 1 < n:
            sends.append((g[:, :, before + d:], r + 1))
        if before and r + 1 < n:
            recvs.append((gx[:, :, d - before:], r + 1))
        if after and r > 0:
            recvs.append((gx[:, :, :after], r - 1))
        got = exchange(sends, recvs, group)
        if before and r + 1 < n:
            gx[:, :, d - before:] += got.pop(0)
        if after and r > 0:
            gx[:, :, :after] += got.pop(0)
        return gx, None, None, None


def exchange_depth_halos(x: torch.Tensor, before: int, after: int,
                         group: Optional[DataGroup]) -> torch.Tensor:
    """This rank's depth band ``x`` (axis 2) padded with ``before`` planes
    of the rank before it and ``after`` of the rank after it; without a
    group, with zeros (SAME padding of a whole volume). Differentiable."""
    if before > x.shape[2] or after > x.shape[2]:
        raise ValueError(f"local depth band of {x.shape[2]} planes smaller "
                         f"than a layer's halo ({before}, {after})")
    if group is None:
        return F.pad(x, (0, 0, 0, 0, before, after))
    return _DepthHalos.apply(x, before, after, group)


@dataclass
class DepthBand:
    """One rank's band of a volume: ``size`` planes from ``start`` of
    ``total``, on ``group``; at a deeper level of the U-Net the band and
    the volume shrink together."""
    group: DataGroup
    start: int
    size: int
    total: int

    def total_at(self, depth: int) -> int:
        """The volume's depth at the level where this band has ``depth``
        planes."""
        return self.total * depth // self.size


def conv3d_band(x: torch.Tensor, weight: torch.Tensor, stride: int,
                band: DepthBand) -> torch.Tensor:
    """SAME ``F.conv3d`` (no bias) of the band ``x`` of ``band``'s volume:
    the depth padding from the neighbours, H and W padded locally."""
    kd, kh, kw = weight.shape[2:]
    d = x.shape[2]
    before, after = same_pads(band.total_at(d), kd, stride)
    if d % stride:
        raise ValueError(f"a band of {d} planes is not a whole number of "
                         f"stride-{stride} steps")
    x = exchange_depth_halos(x, before, after, band.group)
    pads: List[int] = []
    for n, k in ((x.shape[4], kw), (x.shape[3], kh)):
        pads.extend(same_pads(int(n), k, stride))
    if any(pads):
        x = F.pad(x, pads)
    return F.conv3d(x, weight, None, stride)


def _validate(x: torch.Tensor, kernels: Sequence[torch.Tensor],
              group: DataGroup) -> Tuple[int, ...]:
    """JAX's ``_validate``: odd kernel sides, a depth the ranks divide, a
    band no thinner than a halo; returns each layer's halo."""
    halos = []
    for k in kernels:
        kd, kh, kw = (int(s) for s in k.shape[2:])
        if kd % 2 != 1:
            raise ValueError("kernel depth must be odd for SAME halo "
                             "sharding")
        if kh % 2 != 1 or kw % 2 != 1:
            raise ValueError("kernel H/W must be odd (symmetric local "
                             f"padding == SAME); got {(kd, kh, kw)}")
        halos.append((kd - 1) // 2)
    if x.shape[2] % group.world:
        raise ValueError(f"depth {x.shape[2]} not divisible by "
                         f"{group.world} shards")
    if any(h and x.shape[2] // group.world < h for h in halos):
        raise ValueError("local depth band smaller than a layer's halo")
    return tuple(halos)


def conv3d_stack_depth_sharded(x: torch.Tensor, kernels, group: DataGroup
                               ) -> torch.Tensor:
    """A stack of SAME stride-1 conv3d layers (ReLU between), ``x``
    ``(N, Cin, D, H, W)`` the whole volume and each kernel ``(Cout, Cin,
    kd, kh, kw)``, on ``group``'s ranks: returns this rank's band of the
    output (rank ``r`` holds planes ``r * D / world`` onwards). Each layer
    exchanges its halos (``(kd - 1) / 2`` planes a side) and the band
    itself never leaves its rank."""
    _validate(x, kernels, group)
    size = x.shape[2] // group.world
    band = DepthBand(group, group.rank * size, size, x.shape[2])
    y = x.narrow(2, band.start, size)
    for i, k in enumerate(kernels):
        y = conv3d_band(y, k.to(y.dtype), 1, band)
        if i + 1 < len(kernels):
            y = torch.relu(y)
    return y


def conv3d_depth_sharded(x: torch.Tensor, kernel: torch.Tensor,
                         group: DataGroup) -> torch.Tensor:
    """One SAME conv3d depth-sharded over ``group``: this rank's band of
    the output (:func:`conv3d_stack_depth_sharded` of one layer)."""
    return conv3d_stack_depth_sharded(x, [kernel], group)


# ---------------------------------------------------------------------------
# The (data, depth) grid and the whole 3-D U-Net
# ---------------------------------------------------------------------------

@dataclass
class DepthGrid:
    """One rank's place on a ``(data, depth)`` grid, laid out data-major
    as ``make_recon_grid`` lays out ``(data, coil)``: ``data`` joins the
    ranks holding other rows of a batch, ``depth`` the ranks holding other
    bands of the same rows (None for a sub-group of one)."""
    world: DataGroup
    data: Optional[DataGroup]
    depth: Optional[DataGroup]

    @property
    def device(self) -> torch.device:
        return self.world.device


def make_depth_mesh(group: DataGroup, n_depth: int) -> DepthGrid:
    """The ``(group.world / n_depth, n_depth)`` grid over ``group``
    (``make_recon_grid``'s sub-groups, the coil axis as the depth axis);
    raises where ``n_depth`` does not divide the group."""
    if n_depth < 1 or group.world % n_depth:
        raise ValueError(f"need a multiple of {n_depth} ranks for a "
                         f"{n_depth}-way depth axis, have {group.world}")
    g: ReconGrid = make_recon_grid(group, group.world // n_depth, n_depth)
    return DepthGrid(group, g.data, g.coil)


def depth_bands(depth: int, world: int, unit: int
                ) -> Optional[List[Tuple[int, int]]]:
    """``(start, size)`` of each rank's band of ``depth`` planes, cut in
    whole ``unit``s (the first ``units % world`` ranks one unit more), or
    None where there are fewer units than ranks (replicated)."""
    if depth % unit:
        raise ValueError(f"depth {depth} is not a multiple of the model's "
                         f"{unit}-plane stride")
    units = depth // unit
    if units < world:
        return None
    out, at = [], 0
    for r in range(world):
        size = (units // world + (r < units % world)) * unit
        out.append((at, size))
        at += size
    return out


@contextmanager
def depth_sharded(model: torch.nn.Module, band: Optional[DepthBand]
                  ) -> Iterator[None]:
    """Inside the block, ``model``'s ``SameConv3d`` and ``InstanceNorm``
    layers run on ``band`` (None: the whole volume); see the module
    docstring."""
    layers = [m for m in model.modules() if hasattr(m, "depth_band")]
    for m in layers:
        m.depth_band = band
    try:
        yield
    finally:
        for m in layers:
            m.depth_band = None


def band_for(x: torch.Tensor, group: Optional[DataGroup], unit: int
             ) -> Tuple[torch.Tensor, Optional[DepthBand],
                        Optional[List[Tuple[int, int]]]]:
    """This rank's band of the volume ``x`` (depth axis 2), its
    :class:`DepthBand` and every rank's ``(start, size)``; ``x`` itself
    and None, None where it is replicated (no group, or fewer units than
    ranks)."""
    if group is None:
        return x, None, None
    bands = depth_bands(int(x.shape[2]), group.world, unit)
    if bands is None:
        return x, None, None
    start, size = bands[group.rank]
    return (x.narrow(2, start, size),
            DepthBand(group, start, size, int(x.shape[2])), bands)


def gather_depth(local: torch.Tensor, bands: List[Tuple[int, int]],
                 group: DataGroup) -> torch.Tensor:
    """The whole volume on every rank from each rank's band (axis 2): one
    all-reduce of a zeroed buffer each rank fills with its band (exact,
    one non-zero addend an element)."""
    shape = list(local.shape)
    shape[2] = sum(size for _, size in bands)
    full = local.new_zeros(shape)
    start, size = bands[group.rank]
    full.narrow(2, start, size).copy_(local)
    return all_reduce_(full, group)


def unet3d_depth_sharded_apply(model: torch.nn.Module,
                               group: Optional[DataGroup]):
    """``f(x) -> logits`` for whole volumes ``(N, C, D, H, W)`` (D a
    multiple of the model's stride), each rank running its band of every
    activation; the whole logits come back on every rank. A depth of
    fewer units than ranks runs replicated."""
    unit = 2 ** (len(model.channels) - 1)

    def run(x: torch.Tensor) -> torch.Tensor:
        xb, band, bands = band_for(x, group, unit)
        if band is None:
            return model(x)
        with depth_sharded(model, band):
            y = model(xb)
        return gather_depth(y, bands, group)

    return run
