"""GRAPPA k-space interpolation: geometry on the host, solve and fill on
the device.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/grappa.py:148-438``,
the same class surface (``Grappa(kspace, kernel_size, coil_axis)``,
``compute_grams``, ``compute_weights(_batch)``, ``apply_weights``,
``apply_weights_pair``, ``apply_weights_pair_multi``,
``apply_weights_batch``) and the same arithmetic:

- the kernel geometries are the unique ``kernel_size`` sampling patches
  whose centre is a hole, found by ``np.unique`` over the mask alone; a
  verbatim numpy copy, so geometry ids are the JAX package's;
- the weights are Tikhonov-regularized least squares, ``W = (S^H S +
  lamda0 I)^-1 S^H T`` with ``lamda0 = 0.01 ||S^H S||_F / ns``, and every
  geometry's normal equations are submatrices of one Gram matrix ``G =
  W^H W`` of the ACS windows (``compute_grams``: windows by ``unfold`` on
  the device, one batched complex matmul); all (slices x geometries)
  systems, padded to one size with identity rows, go to one batched
  ``torch.linalg.solve``;
- the holes are filled by one real convolution a geometry over the
  geometry's bounding box, on 2 x coils channels with the block kernel
  ``[[Wr, Wi], [-Wi, Wr]]``, kept where the geometry map names it. Many
  slices, each with its own weights, run as one grouped convolution.

Matmuls and convolutions run with TF32 off (``utils/device.py:
f32_on_card``), as the JAX version runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from numpy.lib.stride_tricks import sliding_window_view

from ..ops.cpair import csolve, to_complex, to_pair_device
from ..utils.device import f32_on_card, resolve_device

# device copies of a chunk's k-space that stay live in the hole-fill
# (input, padded real channels, output, one geometry's convolution, the
# sum): the T2 and DWI pipelines size their chunks of slices by it
STAGE_COPIES = 8

MESH_REFUSAL = ("mesh= (slices sharded over several cards) is not ported; "
                "it waits for ROADMAP.md Queue 1 item 7 (parallelism)")


def refuse_mesh(mesh) -> None:
    """Raise for any ``mesh`` but None."""
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSAL)


def _as_complex(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``(complex view, whether x was a real (..., 2) pair)``."""
    if x.is_complex():
        return x, False
    return torch.view_as_complex(x.float().contiguous()), True


def _block_kernel(weights_c: np.ndarray, cells: np.ndarray, kx: int, ky: int,
                  nc: int) -> np.ndarray:
    """``(nc, ncells*nc)`` complex weights -> ``(kx, ky, 2nc, 2nc)`` real
    block kernel (HWIO). Source order matches the boolean-mask flattening
    (cell-major, coils contiguous)."""
    k = np.zeros((kx, ky, 2 * nc, 2 * nc), np.float32)
    for ci, (ox, oy) in enumerate(cells):
        w = weights_c[:, ci * nc:(ci + 1) * nc]        # (nc_out, nc_in)
        wr, wi = w.real.T, w.imag.T                    # (nc_in, nc_out)
        k[ox, oy, :nc, :nc] = wr
        k[ox, oy, nc:, :nc] = -wi
        k[ox, oy, :nc, nc:] = wi
        k[ox, oy, nc:, nc:] = wr
    return k


def _apply_kernels_conv(x: torch.Tensor, kernels: torch.Tensor,
                        geom_map: torch.Tensor, bounds: Sequence[tuple],
                        groups: int) -> torch.Tensor:
    """The hole values of every geometry, by per-geometry convolutions
    over each geometry's bounding box.

    ``x``: ``(B, groups * 2nc, Xp, Yp)`` zero-padded k-space, each group's
    channels its real parts then its imaginary parts; ``kernels``:
    ``(G, groups * 2nc, 2nc, kx, ky)`` grouped block kernels;
    ``geom_map``: ``(X, Y)`` geometry index of each position (-1 for no
    hole); ``bounds``: each geometry's half-open ``(x0, x1, y0, y1)``.
    Returns ``(B, groups * 2nc, X, Y)``, zero where no geometry fills."""
    kx, ky = kernels.shape[-2:]
    out = x.new_zeros(x.shape[:2] + (x.shape[2] - kx + 1,
                                     x.shape[3] - ky + 1))
    for g, (x0, x1, y0, y1) in enumerate(bounds):
        o = F.conv2d(x[:, :, x0:x1 + kx - 1, y0:y1 + ky - 1], kernels[g],
                     groups=groups)
        sel = (geom_map[x0:x1, y0:y1] == g).to(o.dtype)
        out[:, :, x0:x1, y0:y1].addcmul_(o, sel)
    return out


class Grappa:
    """GRAPPA interpolator with the prostate code's class surface; its
    device work runs on ``device``."""

    def __init__(self, kspace: np.ndarray,
                 kernel_size: Tuple[int, int] = (5, 5),
                 coil_axis: int = -1,
                 device: str | torch.device = "cuda") -> None:
        self.kernel_size = tuple(kernel_size)
        self.coil_axis = coil_axis
        self.lamda = 0.01
        self.device = resolve_device(device)
        # the geometry depends only on the example slice's sampling mask
        self.kernel_var_dict = self._get_kernel_geometries(
            np.moveaxis(np.asarray(kspace), coil_axis, -1))

    # ------------------------------------------------------------------

    def _get_kernel_geometries(self, kspace: np.ndarray):
        kx, ky = self.kernel_size
        kx2, ky2 = kx // 2, ky // 2
        nc = kspace.shape[-1]

        if np.sum(np.abs(kspace[..., 0]) == 0) == 0:
            return {"patches": np.zeros((0, kx, ky, nc), bool),
                    "patch_indices": np.zeros((0,), int),
                    "holes_x": {}, "holes_y": {},
                    "iidx_map": np.full(kspace.shape[:2], -1, np.int32)}

        kpad_mask = np.pad(np.abs(kspace[..., 0]) > 0,
                           ((kx2, kx2), (ky2, ky2)), mode="constant")
        windows = sliding_window_view(kpad_mask, (kx, ky))
        psh = windows.shape[:2]
        flat = windows.reshape(-1, kx, ky)
        uniq, iidx = np.unique(flat, return_inverse=True, axis=0)

        valid = np.argwhere(~uniq[:, kx2, ky2]).squeeze()
        empty = np.argwhere(np.all(uniq == 0, axis=(1, 2)))
        valid = np.setdiff1d(np.atleast_1d(valid), empty, assume_unique=True)
        valid = np.atleast_1d(valid)

        patches = np.tile(uniq[..., None], (1, 1, 1, nc))

        holes_x, holes_y = {}, {}
        for ii in valid:
            idx = np.unravel_index(np.argwhere(iidx == ii), psh)
            holes_x[ii] = np.atleast_1d((idx[0] + kx2).squeeze())
            holes_y[ii] = np.atleast_1d((idx[1] + ky2).squeeze())
        # position -> unique-patch id (the conv apply path selects each
        # pixel's geometry output from this map)
        iidx_map = iidx.reshape(psh).astype(np.int32)
        return {"patches": patches, "patch_indices": valid,
                "holes_x": holes_x, "holes_y": holes_y,
                "iidx_map": iidx_map}

    def _element_coils_last(self, stack, lead: int):
        """Move the coil axis of each element of ``stack`` (``lead``
        leading batch axes, complex layout) to the end."""
        ax = lead + (self.coil_axis % (stack.ndim - lead))
        return ax, (np.moveaxis(stack, ax, -1) if isinstance(stack, np.ndarray)
                    else stack.movedim(ax, -1))

    # ------------------------------------------------------------------

    def compute_weights(self, calib: np.ndarray) -> Dict[int, np.ndarray]:
        """Per-geometry weights from one slice's ACS data."""
        return self.compute_weights_batch(np.asarray(calib)[None])[0]

    def compute_grams(self, calibs: np.ndarray) -> np.ndarray:
        """Host ``(S, K, K)`` complex64 Gram matrices ``W^H W`` of each
        slice's zero-padded ACS windows, columns in ``(kx, ky, nc)`` order,
        ``K = kx * ky * nc``. They depend on the calibration and the kernel
        size only, so one result serves Grappa objects of other sampling
        geometries (the T2 pipeline's two)."""
        calibs = np.asarray(calibs, np.complex64)
        kx, ky = self.kernel_size
        kx2, ky2 = kx // 2, ky // 2
        with f32_on_card(self.device):
            c = torch.from_numpy(np.ascontiguousarray(calibs)).to(
                self.device)
            _, c = self._element_coils_last(c, 1)       # (S, X, Y, nc)
            s, x, y, nc = c.shape
            padded = c.new_zeros((s, x + 2 * kx2, y + 2 * ky2, nc))
            padded[:, kx2:kx2 + x, ky2:ky2 + y] = c
            win = padded.unfold(1, kx, 1).unfold(2, ky, 1)
            w = win.permute(0, 1, 2, 4, 5, 3).reshape(s, x * y, kx * ky * nc)
            return (w.mH @ w).cpu().numpy()

    def compute_weights_batch(self, calibs: np.ndarray,
                              grams: np.ndarray = None) -> list:
        """Per-geometry weights for a stack of calibration slices: a list
        of ``S`` dicts ``{geometry id: (nc, ns) complex}``.

        ``calibs``: ``(S, ...)``, each element as ``compute_weights`` takes
        it (coil axis at ``self.coil_axis`` of the element). ``grams``, a
        ``compute_grams(calibs)`` result, spares recomputing it. Every
        geometry's ``S^H S`` and ``S^H T`` are submatrices of the Gram
        matrix (the centre targets are columns of the windows); the
        systems are padded to one size with identity rows, whose solutions
        are exactly zero, and all ``S x G`` of them are solved in one call.
        """
        calibs = np.asarray(calibs)
        if grams is None:
            grams = self.compute_grams(calibs)
        _, calibs = self._element_coils_last(calibs, 1)
        s_count, nc = calibs.shape[0], calibs.shape[-1]
        kx, ky = self.kernel_size
        kx2, ky2 = kx // 2, ky // 2

        valid = self.kernel_var_dict["patch_indices"]
        if len(valid) == 0:
            return [{} for _ in range(s_count)]
        center_cols = (kx2 * ky + ky2) * nc + np.arange(nc)
        cols_per_geom = [np.flatnonzero(
            self.kernel_var_dict["patches"][ii].ravel()) for ii in valid]
        ns_max = max(len(c) for c in cols_per_geom)

        g_count = len(valid)
        shs = np.zeros((s_count, g_count, ns_max, ns_max), np.complex64)
        sht = np.zeros((s_count, g_count, ns_max, nc), np.complex64)
        lamda0 = np.zeros((s_count, g_count), np.float32)
        for gi, cols in enumerate(cols_per_geom):
            ns = len(cols)
            sub = grams[:, cols[:, None], cols[None, :]]      # (S, ns, ns)
            shs[:, gi, :ns, :ns] = sub
            shs[:, gi, ns:, ns:] = np.eye(ns_max - ns)        # inert padding
            sht[:, gi, :ns] = grams[:, cols[:, None], center_cols[None, :]]
            lamda0[:, gi] = self.lamda * np.linalg.norm(
                sub, axis=(1, 2)) / ns

        with f32_on_card(self.device):
            a = torch.from_numpy(shs.reshape(-1, ns_max, ns_max)).to(
                self.device)
            a.diagonal(dim1=-2, dim2=-1).add_(
                torch.from_numpy(lamda0.reshape(-1, 1)).to(self.device))
            b = torch.from_numpy(sht.reshape(-1, ns_max, nc)).to(self.device)
            w_all = csolve(a, b).mT.cpu().numpy().reshape(
                s_count, g_count, nc, ns_max)
        return [{ii: w_all[si, gi][:, :len(cols_per_geom[gi])]
                 for gi, ii in enumerate(valid)} for si in range(s_count)]

    # ------------------------------------------------------------------

    def _conv_materials(self, weights: Dict[int, np.ndarray], nc: int):
        """The geometry map, the per-geometry block kernels (HWIO) and each
        geometry's hole bounding box, for the conv apply path."""
        kx, ky = self.kernel_size
        valid = self.kernel_var_dict["patch_indices"]
        iidx_map = self.kernel_var_dict["iidx_map"]
        geom_map = np.full(iidx_map.shape, -1, np.int32)
        kernels = np.zeros((max(len(valid), 1), kx, ky, 2 * nc, 2 * nc),
                           np.float32)
        bounds = []
        for gi, ii in enumerate(valid):
            where = iidx_map == ii
            geom_map[where] = gi
            xs, ys = np.nonzero(where)
            bounds.append((int(xs.min()), int(xs.max()) + 1,
                           int(ys.min()), int(ys.max()) + 1))
            cells = np.argwhere(self.kernel_var_dict["patches"][ii][..., 0])
            kernels[gi] = _block_kernel(np.asarray(weights[ii]), cells,
                                        kx, ky, nc)
        return geom_map, kernels, tuple(bounds)

    def apply_weights(self, kspace: np.ndarray,
                      weights: Dict[int, np.ndarray]) -> np.ndarray:
        """Fill every hole of one slice; host complex in and out."""
        return self.apply_weights_batch(
            np.asarray(kspace)[None], weights)[0]

    def apply_weights_pair(self, kspace_pair: torch.Tensor,
                           weights: Dict[int, np.ndarray]) -> torch.Tensor:
        """Fill the holes of a ``(B, ...)`` stack on its device, one weight
        set for all: a real ``(..., 2)`` pair or a complex tensor, each
        element laid out as ``apply_weights`` takes it. The result stays on
        the device, in the input's form."""
        return self.apply_weights_pair_multi(kspace_pair[None],
                                             [weights])[0]

    def apply_weights_pair_multi(self, kspace_pair: torch.Tensor,
                                 weights_per_slice, mesh=None
                                 ) -> torch.Tensor:
        """Fill the holes of many slices, each with its own weights and the
        shared sampling geometry, in one grouped convolution a geometry.

        ``kspace_pair``: ``(S, B, ...)``, slices first, then the batch of
        each slice (such as its averages), elements as in
        ``apply_weights_pair``; ``weights_per_slice``: ``S`` weight dicts
        (a sequence, or a dict by slice). ``mesh`` is refused: sharding
        slices over cards waits for ROADMAP.md Queue 1 item 7."""
        refuse_mesh(mesh)
        k, pair = _as_complex(kspace_pair)
        ax, k = self._element_coils_last(k, 2)         # (S, B, X, Y, nc)
        s, b, x, y, nc = k.shape
        kx, ky = self.kernel_size
        kx2, ky2 = kx // 2, ky // 2
        mats = [self._conv_materials(weights_per_slice[si], nc)
                for si in range(s)]
        geom_map, _, bounds = mats[0]
        with f32_on_card(k.device):
            # (B, S * 2nc, Xp, Yp): per slice its real, then imaginary parts
            xin = k.real.new_zeros((b, s * 2 * nc, x + 2 * kx2,
                                    y + 2 * ky2))
            xin[:, :, kx2:kx2 + x, ky2:ky2 + y] = torch.view_as_real(
                k).permute(1, 0, 5, 4, 2, 3).reshape(b, s * 2 * nc, x, y)
            # per geometry, the slices' HWIO kernels as one grouped OIHW
            kern = torch.from_numpy(np.stack([m[1] for m in mats])).to(
                k.device)                              # (S, G, kx, ky, I, O)
            kern = kern.permute(1, 0, 5, 4, 2, 3).reshape(
                kern.shape[1], s * 2 * nc, 2 * nc, kx, ky)
            vals = _apply_kernels_conv(
                xin, kern, torch.from_numpy(geom_map).to(k.device), bounds,
                groups=s)
            vals = vals.reshape(b, s, 2, nc, x, y).permute(1, 0, 4, 5, 3, 2)
            out = (k + torch.view_as_complex(vals.contiguous())).movedim(
                -1, ax)
        return torch.view_as_real(out) if pair else out

    def apply_weights_batch(self, kspaces: np.ndarray,
                            weights: Dict[int, np.ndarray]) -> np.ndarray:
        """Fill the holes of a ``(B, ...)`` stack sharing one sampling
        pattern and weight set (the averages of a slice) in one
        convolution a geometry; host complex in and out. Holes are zero in
        the input, so adding the convolution (zero off the holes) gives the
        prostate code's ``recon + kspace``."""
        pair = to_pair_device(np.ascontiguousarray(kspaces),
                              device=self.device)
        return to_complex(self.apply_weights_pair(pair, weights))
