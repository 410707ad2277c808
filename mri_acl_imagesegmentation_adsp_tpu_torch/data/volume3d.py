"""Device-resident 3-D volume store with ROI patch sampling on the device.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/volume3d.py``
(``DeviceVolumeStore``, ``_sample_patches``). Every z-scored volume is
uploaded once, zero-padded to a common slice count ``(V, S_max, H, W)``,
with a table of up to ``max_pos`` positive-voxel coordinates per volume
drawn on the host from ``seed`` (the JAX store's table, value for value).
``sample_batch`` then draws everything on the device from an explicit
``torch.Generator``: the volume, the positive-bias coin (``ratio / (1 +
ratio)``, positive only where the volume has positives), the centre (from
the table, or uniform in the volume's own extent), the centre clipping of
the host sampler, and the ``(D, Y, X)`` slice, so a train step needs no
host-to-device copy. Its random stream is torch's, not JAX's; the
semantics are the same. A start past ``S_max - D`` is clamped as
``lax.dynamic_slice`` clamps it.

``min_depth`` zero-pads the store's slice axis to at least that depth, so a
ROI deeper than every volume gives patches zero-padded to the full ROI, as
the host sampler gives them (the JAX trainer instead shrinks the patch
depth to ``S_max``, a shape the host sampler never gives, which the U-Net
cannot halve evenly at, e.g., 45 slices).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .hbm_loader import read_list


class DeviceVolumeStore:
    """Padded ``(V, S_max, H, W)`` device tensors + positive-coordinate
    table."""

    def __init__(self, list_txt: str, max_pos: int = 4096, seed: int = 0,
                 device: str | torch.device = "cuda", min_depth: int = 0):
        dev = resolve_device(device)
        files = read_list(list_txt)
        rng = np.random.default_rng(seed)
        vols, msks, sizes = [], [], []
        for p in files:
            with np.load(p) as z:
                x = z["img"].astype(np.float32)[:, 0]      # (S, H, W)
                y = z["msk"].astype(np.int32)
            x = (x - x.mean()) / (x.std() + 1e-6)          # per-volume z-score
            vols.append(x)
            msks.append(y)
            sizes.append(x.shape)
        s_max = max(max(v.shape[0] for v in vols), int(min_depth))
        h, w = vols[0].shape[1:]
        if any(v.shape[1:] != (h, w) for v in vols):
            raise ValueError("volumes must share (H, W) for the device store")

        imgs = np.zeros((len(vols), s_max, h, w), np.float32)
        masks = np.zeros((len(vols), s_max, h, w), np.int32)
        pos_tab = np.zeros((len(vols), max_pos, 3), np.int32)
        pos_cnt = np.zeros((len(vols),), np.int32)
        for i, (v, m) in enumerate(zip(vols, msks)):
            imgs[i, : v.shape[0]] = v
            masks[i, : m.shape[0]] = m
            zz, yy, xx = np.nonzero(m > 0)
            if len(zz):
                take = rng.integers(0, len(zz), size=max_pos)
                pos_tab[i] = np.stack([zz[take], yy[take], xx[take]], axis=1)
                pos_cnt[i] = min(len(zz), max_pos)

        self.files = files
        self.device = dev
        self.images = torch.from_numpy(imgs).to(dev)
        self.masks = torch.from_numpy(masks).to(dev)
        self.sizes = torch.from_numpy(np.asarray(sizes, np.int64)).to(dev)
        self.pos_tab = torch.from_numpy(pos_tab.astype(np.int64)).to(dev)
        self.pos_cnt = torch.from_numpy(pos_cnt.astype(np.int64)).to(dev)
        self.num_volumes = len(files)

    def draw_corners(self, generator: torch.Generator, batch: int,
                     roi: Sequence[int], pos_neg_ratio: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The volumes ``(B,)`` and ``(z, y, x)`` starts ``(B, 3)`` of
        ``batch`` patches of ``roi`` (reference order ``(Y, X, D)``), drawn
        on the device from ``generator``."""
        yy, xx, dd = (int(r) for r in roi)
        _, s_max, h_max, w_max = self.images.shape
        if dd > s_max or yy > h_max or xx > w_max:
            raise ValueError(f"roi {tuple(roi)} exceeds the store's "
                             f"(S, H, W) = {(s_max, h_max, w_max)}")
        dev = self.device
        u = torch.rand((int(batch), 6), generator=generator, device=dev,
                       dtype=torch.float64)
        v = torch.clamp((u[:, 0] * self.num_volumes).long(),
                        max=self.num_volumes - 1)
        size = self.sizes[v]                                # (B, 3)
        cnt = self.pos_cnt[v]
        want_pos = (u[:, 1] < pos_neg_ratio / (1.0 + pos_neg_ratio)) & (
            cnt > 0)
        j = torch.minimum((u[:, 2] * cnt.clamp_min(1)).long(),
                          cnt.clamp_min(1) - 1)
        c_pos = self.pos_tab[v, j]                          # (B, 3) z, y, x
        c_neg = torch.minimum((u[:, 3:6] * size).long(), size - 1)
        c = torch.where(want_pos[:, None], c_pos, c_neg)
        extent = torch.tensor([dd, yy, xx], device=dev)
        limit = torch.tensor([s_max, h_max, w_max], device=dev)
        start = torch.minimum(
            torch.clamp(c - extent // 2, min=torch.zeros_like(c),
                        max=torch.clamp_min(size - extent, 0)),
            limit - extent)
        return v, start

    def sample_batch(self, generator: torch.Generator, batch: int,
                     roi: Sequence[int], pos_neg_ratio: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(B, 1, D, Y, X)`` float patches and ``(B, D, Y, X)`` int
        masks at the corners :meth:`draw_corners` draws."""
        v, start = self.draw_corners(generator, batch, roi, pos_neg_ratio)
        yy, xx, dd = (int(r) for r in roi)
        ar = [torch.arange(n, device=self.device) for n in (dd, yy, xx)]
        idx = (v[:, None, None, None],
               (start[:, 0, None] + ar[0])[:, :, None, None],
               (start[:, 1, None] + ar[1])[:, None, :, None],
               (start[:, 2, None] + ar[2])[:, None, None, :])
        return self.images[idx][:, None], self.masks[idx]
