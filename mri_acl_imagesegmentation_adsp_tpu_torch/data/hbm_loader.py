"""Device-resident slice store: the whole preprocessed split on the card.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/hbm_loader.py:30-227``:
``read_list``, ``SliceStore`` (``from_files``, ``neighbor_table``,
``to_device``), ``DeviceSliceStore``, ``gather_batch`` and
``epoch_permutation``. Every ``volume.npz`` of a split is loaded once into
flat ``(N, H, W)`` arrays on the device; a training step forms its batch by
``index_select`` with rows of a permutation drawn on the device, so no batch
crosses from the host. The 2.5-D neighbour channels are an ``(N, k)`` index
table, edge-clamped inside each volume.

Volumes are read through the native C++ npz loader (``native/loader.py``):
one call a volume, or with ``workers`` all of them on its C++ thread pool;
``np.load`` reads a volume the native loader cannot (no ``g++``, an
unusual member).

Sharded (``to_device(..., group=, shard=True)``, JAX
``hbm_loader.py:134-175``): each rank of a data-parallel group holds
``1/world`` of the rows, the store padded with repeats of its last slice
to a multiple of the world (padding rows are never indexed: permutations
draw from ``[0, N)``). A batch indexes the global rows, so a rank's rows
may live on another rank: :func:`gather_batch` then has every rank fill
the rows it owns into a zeroed global batch, and one all-reduce sums
them, which is exact (one owner a row). Every rank must gather the same
rows together. The neighbour table, a few bytes a slice, stays whole on
every rank.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.norm import at_least_f32
from ..native import load_volume_npz, load_volumes_npz
from ..parallel.mesh import DataGroup, all_reduce_


def read_list(txt_path: str) -> List[str]:
    """One ``volume.npz`` path per non-empty line."""
    with open(txt_path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _store_types(img: np.ndarray, msk: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    return img.astype(np.float32, copy=False), msk.astype(np.int32)


def _load_one(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One volume's ``(img, msk)``: the native reader, else ``np.load``."""
    loaded = load_volume_npz(path)
    if loaded is None:
        with np.load(path) as z:
            loaded = z["img"], z["msk"]
    return _store_types(*loaded)


@dataclass
class SliceStore:
    """Flat, volume-ordered slice arrays on the host."""
    images: np.ndarray        # (N, H, W) float32, z-scored
    masks: np.ndarray         # (N, H, W) int32, {0, 1} or class labels
    vol_starts: np.ndarray    # (V,) int64 first row of each volume
    vol_sizes: np.ndarray     # (V,) int64 slices of each volume
    files: List[str]

    @classmethod
    def from_list(cls, list_txt: str, workers: int = 0) -> "SliceStore":
        return cls.from_files(read_list(list_txt), workers=workers)

    @classmethod
    def from_files(cls, files: Sequence[str],
                   workers: int = 0) -> "SliceStore":
        """Load ``img`` ``(S, 1, H, W)`` and ``msk`` ``(S, H, W)`` of each
        pack; with ``workers`` and several files, on the native loader's
        thread pool (or ``workers`` threads where it is unavailable)."""
        if not files:
            raise ValueError("Empty volume list")
        loaded = None
        if workers and len(files) > 1:
            bulk = load_volumes_npz(list(files), threads=workers)
            if bulk is not None:
                loaded = [_load_one(p) if pair is None
                          else _store_types(*pair)
                          for p, pair in zip(files, bulk)]
            else:
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    loaded = list(ex.map(_load_one, files))
        if loaded is None:
            loaded = [_load_one(p) for p in files]
        sizes = np.asarray([x.shape[0] for x, _ in loaded], np.int64)
        return cls(
            images=np.concatenate([x[:, 0] for x, _ in loaded], axis=0),
            masks=np.concatenate([y for _, y in loaded], axis=0),
            vol_starts=np.concatenate([[0], np.cumsum(sizes)[:-1]]
                                      ).astype(np.int64),
            vol_sizes=sizes,
            files=list(files),
        )

    def __len__(self) -> int:
        return self.images.shape[0]

    def neighbor_table(self, k: int) -> np.ndarray:
        """``(N, k)`` int32 rows of each slice's 2.5-D stack: offsets
        ``-k//2 .. k//2``, clamped to the slice's own volume."""
        if k < 1 or k % 2 != 1:
            raise ValueError(f"k must be odd (1, 3, 5, ...), got {k}")
        half = k // 2
        starts = np.repeat(self.vol_starts, self.vol_sizes)
        ends = starts + np.repeat(self.vol_sizes, self.vol_sizes) - 1
        base = np.arange(len(self))
        return np.stack([np.clip(base + d, starts, ends)
                         for d in range(-half, half + 1)],
                        axis=1).astype(np.int32)

    def to_device(self, k: int = 1, image_dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda",
                  group: Optional[DataGroup] = None,
                  shard: bool = False) -> "DeviceSliceStore":
        """Copy the store and its neighbour table for ``k`` to ``device``.
        Masks go as uint8 when every label is below 256, else int32. With
        ``group`` and ``shard`` only this rank's rows of the padded store
        go (module docstring)."""
        mask_dtype = (torch.uint8 if np.max(self.masks, initial=0) < 256
                      else torch.int32)
        images, masks, row0 = self.images, self.masks, 0
        if group is not None and shard:
            pad = (-len(self)) % group.world
            if pad:
                images = np.concatenate([images, images[-1:].repeat(pad, 0)])
                masks = np.concatenate([masks, masks[-1:].repeat(pad, 0)])
            share = images.shape[0] // group.world
            row0 = group.rank * share
            images = images[row0:row0 + share]
            masks = masks[row0:row0 + share]
        return DeviceSliceStore(
            images=torch.from_numpy(np.ascontiguousarray(images)).to(
                device, image_dtype),
            masks=torch.from_numpy(np.ascontiguousarray(masks)).to(
                device, mask_dtype),
            neighbors=torch.from_numpy(
                self.neighbor_table(k).astype(np.int64)).to(device),
            k=k,
            num_slices=len(self),
            group=group if shard else None,
            row0=row0,
        )


@dataclass
class DeviceSliceStore:
    """The store's tensors on one device."""
    images: torch.Tensor      # (N, H, W) float32 or bfloat16
    masks: torch.Tensor       # (N, H, W) uint8 (int32 if labels >= 256)
    neighbors: torch.Tensor   # (N, k) int64
    k: int
    num_slices: int
    group: Optional[DataGroup] = None   # set when the rows are sharded
    row0: int = 0                       # the first global row held here

    @property
    def sharded(self) -> bool:
        return self.group is not None


def gather_batch(store: DeviceSliceStore, idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``idx`` ``(B,)`` -> ``x`` ``(B, k, H, W)`` float32 (float64 from a
    float64 store; channels are
    the neighbour slices) and ``y`` ``(B, H, W)``, the centre slice's mask.
    From a sharded store every rank gets the whole batch (a collective)."""
    nbr = store.neighbors.index_select(0, idx)                 # (B, k)
    if store.sharded:
        return _gather_sharded(store, idx, nbr)
    x = store.images.index_select(0, nbr.reshape(-1))
    x = x.reshape(nbr.shape + store.images.shape[1:])
    return at_least_f32(x), store.masks.index_select(0, idx)


def _gather_sharded(store: DeviceSliceStore, idx: torch.Tensor,
                    nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank writes the rows it holds into a zeroed ``(B, k + 1, H,
    W)`` f32 (or float64) buffer (the image channels, then the mask) and
    one all-reduce sums the ranks' buffers."""
    held = store.images.shape[0]
    rows = torch.cat([nbr, idx[:, None]], dim=1) - store.row0  # (B, k + 1)
    mine = (rows >= 0) & (rows < held)
    at = rows.clamp(0, held - 1)
    b, k = nbr.shape
    x = at_least_f32(store.images.index_select(0, at[:, :k].reshape(-1))
                     .reshape((b, k) + store.images.shape[1:]))
    y = store.masks.index_select(0, at[:, k]).to(x.dtype)[:, None]
    buf = torch.where(mine[..., None, None], torch.cat([x, y], dim=1),
                      torch.zeros((), device=x.device))
    all_reduce_(buf, store.group)
    return buf[:, :k], buf[:, k].to(store.masks.dtype)


def epoch_permutation(generator: torch.Generator, num_slices: int,
                      batch_size: int, drop_last: bool = True
                      ) -> torch.Tensor:
    """Shuffled ``(steps, batch)`` int64 row matrix for one epoch, drawn on
    the generator's device. Without ``drop_last`` the last row is filled
    with the permutation's first entries."""
    perm = torch.randperm(num_slices, generator=generator,
                          device=generator.device)
    steps = num_slices // batch_size
    if not drop_last and steps * batch_size < num_slices:
        pad = (steps + 1) * batch_size - num_slices
        perm = torch.cat([perm, perm[:pad]])
        steps += 1
    return perm[:steps * batch_size].reshape(steps, batch_size)
