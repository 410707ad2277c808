"""End-to-end variational network (VarNet) for accelerated MRI recon.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/varnet.py``, the
prostate code's ``models/varnet.py``:

* ``NormUnet`` (:69-139): the complex channels in the order ``[re(all c*a),
  im(all c*a)]``, each sample normalized over its whole tensor (mean and
  ``ddof=1`` std, in f32 even under bf16), H and W zero-padded to multiples
  of 16 around the centre, a fastMRI U-Net, the padding cropped and the
  normalization undone;
* ``SensitivityModel`` (:142-182): a ``NormUnet`` on each coil's ESPIRiT
  image, divided by the root-sum-of-squares over coils;
* ``sens_reduce_parts`` / ``sens_expand_parts`` (:189-207): ``S^H F^-1 k``
  summed over coils (the sum accumulates in f32) and ``F (S x)``;
* ``VarNetBlock`` (:228-268): soft data consistency ``k - where(k0 != 0, k -
  k0, 0) * dc_weight - F S NormUnet(S^H F^-1 k)``, the mask taken per re / im
  component, as the reference takes it on its ``(..., 2)`` pair;
* ``VarNet`` (:271-342): sensitivities from the ESPIRiT maps, the cascades,
  then ``|sens_reduce|`` in f32.

Layouts are the JAX package's: k-space and ESPIRiT maps are real pairs
``(b, coils, aves, h, w, 2)``, the output is ``(b, aves, h, w)`` f32. The
maps may have one average (the per-slice dataset gives ``(coils, 1, h, w,
2)``), which broadcasts against k-space's ``aves``; the sensitivity
network's width follows the maps' averages (``sens_aves``), the cascades'
the k-space's (``aves``), as Flax infers both from its first input.

Complex values are carried as separate re / im tensors through the
cascades, as the JAX package carries them. Each centred FFT forms complex64
from the parts, transforms with ``torch.fft`` (the JAX package's DFT
matmuls, ``ops/fftc.py:119-133`` there) and returns f32 parts; bf16 inputs
are upcast exactly, as the JAX einsum promotes them against its f32 DFT
matrices. Under ``dtype=bfloat16`` (``amp``) the JAX cascade state ``kr, ki,
sr, si`` and the data-consistency terms are bf16, the coil sums and the norm
statistics f32, the products with an FFT's f32 output f32, the expanded
k-space rounded to bf16 before it is subtracted, and the final magnitude
f32; this module places each dtype where the JAX module does, op by op (not
by ``torch.autocast``'s op lists, which would keep the elementwise state in
f32). With ``dtype=float64`` every f32 place above is float64: the tests'
reference run.

The coil-parallel layout (JAX ``:272-288``, ``_constrain`` at :40-53):
``VarNet(mesh=grid)`` with a ``parallel/mesh.py:ReconGrid`` takes the
global batch and keeps this rank's block of it, its rows of the data
sub-group's split and its coils of the coil sub-group's (each by the
divisible rule: an axis the sub-group does not divide stays whole). The
k-space, the ESPIRiT maps, the sensitivities and the cascade state are
then the rank's coils only; the three coil sums (the sensitivity model's
RSS, each cascade's ``sens_reduce_parts`` and the final combine) are
completed by ``all_reduce_sum`` over the coil sub-group, in ``acc_dtype``
across the ranks as within a rank, and cast after it. The combined image
and the regularizer U-Nets are computed again on every coil rank, as in
JAX. With coils the coil sub-group does not divide, nothing is summed
across ranks. The output is the rank's rows. ``mesh=None`` is the one-device
model. The JAX module's phase-space U-Net lowering (``phase_max_chans``,
the same function) has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.fastmri_unet import FastMRIUnet
from ..parallel.mesh import DataGroup, ReconGrid, all_reduce_sum, shard_dim

Parts = Tuple[torch.Tensor, torch.Tensor]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the statistics, coil sums and FFTs under ``dtype``: f32
    for bf16 and f32, float64 for a float64 reference run."""
    return torch.promote_types(dtype, torch.float32)


def _fft2c(re: torch.Tensor, im: torch.Tensor, inverse: bool) -> Parts:
    acc = acc_dtype(re.dtype)
    x = torch.fft.ifftshift(torch.complex(re.to(acc), im.to(acc)),
                            dim=(-2, -1))
    x = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x, norm="ortho")
    x = torch.fft.fftshift(x, dim=(-2, -1))
    return x.real, x.imag


def fft2c_parts(re: torch.Tensor, im: torch.Tensor) -> Parts:
    """Centred orthonormal 2-D FFT of separate re / im tensors ``(..., H,
    W)``, as f32 parts (float64 for float64 input)."""
    return _fft2c(re, im, inverse=False)


def ifft2c_parts(re: torch.Tensor, im: torch.Tensor) -> Parts:
    """Inverse of :func:`fft2c_parts`."""
    return _fft2c(re, im, inverse=True)


class NormUnet(nn.Module):
    """Whole-sample normalization + pad-to-16 around a fastMRI U-Net of
    ``in_chans`` (``2 * coils * aves`` of its input) channels in and out.

    ``forward(x)`` takes a pair ``(b, c, a, h, w, 2)`` (or ``(b, c, h, w,
    2)``) and returns one; ``forward(x, xi)`` takes re and im ``(b, c, a, h,
    w)`` (or ``(b, c, h, w)``) and returns ``(re, im)``."""

    def __init__(self, chans: int, num_pools: int, in_chans: int = 2,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.unet = FastMRIUnet(in_chans, in_chans, chans, num_pools,
                                drop_prob, dtype)

    def forward(self, x: torch.Tensor, xi: Optional[torch.Tensor] = None):
        pair_in = xi is None
        if pair_in:
            if x.shape[-1] != 2:
                raise ValueError("Last dimension must be 2 for complex.")
            if x.dim() == 5:                 # (b, c, h, w, 2) -> add aves
                x = x[:, :, None]
            if x.dim() != 6:
                raise ValueError(f"expected (b,c,a,h,w,2), got "
                                 f"{tuple(x.shape)}")
            xr, xim = x[..., 0], x[..., 1]
        else:
            xr, xim = x, xi
            if xr.dim() == 4:                # (b, c, h, w) -> add aves
                xr, xim = xr[:, :, None], xim[:, :, None]
        b, c, a, h, w = xr.shape

        y = torch.cat([xr.reshape(b, c * a, h, w),
                       xim.reshape(b, c * a, h, w)], dim=1)
        flat = y.reshape(b, -1).to(acc_dtype(y.dtype))
        mean = flat.mean(dim=1).view(b, 1, 1, 1)
        std = flat.var(dim=1, correction=1).sqrt().view(b, 1, 1, 1)
        y = (y - mean.to(y.dtype)) / std.to(y.dtype)

        w_mult = ((w - 1) | 15) + 1
        h_mult = ((h - 1) | 15) + 1
        w_pad = ((w_mult - w) // 2, (w_mult - w + 1) // 2)
        h_pad = ((h_mult - h) // 2, (h_mult - h + 1) // 2)
        y = F.pad(y, (w_pad[0], w_pad[1], h_pad[0], h_pad[1]))
        y = self.unet(y)
        y = y[..., h_pad[0]:h_mult - h_pad[1], w_pad[0]:w_mult - w_pad[1]]
        y = y * std + mean

        yr = y[:, :c * a].reshape(b, c, a, h, w)
        yi = y[:, c * a:].reshape(b, c, a, h, w)
        if pair_in:
            return torch.stack([yr, yi], dim=-1)
        return yr, yi


class SensitivityModel(nn.Module):
    """Coil sensitivities: a ``NormUnet`` on each coil's image, divided by
    the RSS over coils. ``aves`` is the averages axis of the maps it is
    given. ``forward(er, ei)`` on parts ``(b, c, a, h, w)`` returns parts;
    ``forward(pair)`` on ``(b, c, a, h, w, 2)`` returns a pair."""

    def __init__(self, chans: int, num_pools: int, aves: int = 1,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_unet = NormUnet(chans, num_pools, 2 * aves, drop_prob,
                                  dtype)

    def forward(self, er: torch.Tensor, ei: Optional[torch.Tensor] = None,
                coil: Optional[DataGroup] = None):
        """``coil``: the sub-group holding the other coils of these rows,
        over which the RSS's sum is completed."""
        pair_in = ei is None
        if pair_in:
            er, ei = er[..., 0], er[..., 1]
        b, c, a, h, w = er.shape
        xr, xi = self.norm_unet(er.reshape(b * c, 1, a, h, w),
                                ei.reshape(b * c, 1, a, h, w))
        xr, xi = xr.reshape(b, c, a, h, w), xi.reshape(b, c, a, h, w)
        sq = torch.sum(xr * xr + xi * xi, dim=1, dtype=acc_dtype(xr.dtype))
        rss = torch.sqrt(all_reduce_sum(sq, coil)).to(xr.dtype)[:, None]
        xr, xi = xr / rss, xi / rss
        if pair_in:
            return torch.stack([xr, xi], dim=-1)
        return xr, xi


def sens_reduce_parts(kr, ki, sr, si,
                      coil: Optional[DataGroup] = None) -> Parts:
    """``S^H F^-1 k`` summed over coils: parts ``(b, c, a, h, w)`` -> ``(b,
    a, h, w)``; the coil sum accumulates in f32, is completed over the
    ``coil`` sub-group (one all-reduce of both parts) and returns in the
    dtype of the products (f32: the FFT's output is)."""
    ir, ii = ifft2c_parts(kr, ki)
    rr = ir * sr + ii * si              # (ir + i ii) * conj(sr + i si)
    ri = ii * sr - ir * si
    dt = rr.dtype
    rr, ri = rr.sum(dim=1, dtype=acc_dtype(dt)), ri.sum(dim=1,
                                                        dtype=acc_dtype(dt))
    if coil is not None:
        rr, ri = all_reduce_sum(torch.stack([rr, ri]), coil).unbind(0)
    return rr.to(dt), ri.to(dt)


def sens_expand_parts(xr, xi, sr, si) -> Parts:
    """``F (S x)``: parts ``(b, a, h, w)`` -> ``(b, c, a, h, w)``."""
    er = xr[:, None] * sr - xi[:, None] * si
    ei = xr[:, None] * si + xi[:, None] * sr
    return fft2c_parts(er, ei)


def sens_reduce(x: torch.Tensor, sens_maps: torch.Tensor) -> torch.Tensor:
    """Pair form: ``(b, c, a, h, w, 2)`` -> ``(b, a, h, w, 2)``."""
    rr, ri = sens_reduce_parts(x[..., 0], x[..., 1], sens_maps[..., 0],
                               sens_maps[..., 1])
    return torch.stack([rr, ri], dim=-1)


def sens_expand(x: torch.Tensor, sens_maps: torch.Tensor) -> torch.Tensor:
    """Pair form: ``(b, a, h, w, 2)`` -> ``(b, c, a, h, w, 2)``."""
    er, ei = sens_expand_parts(x[..., 0], x[..., 1], sens_maps[..., 0],
                               sens_maps[..., 1])
    return torch.stack([er, ei], dim=-1)


class VarNetBlock(nn.Module):
    """One unrolled iteration on parts: soft data consistency + the
    ``NormUnet`` regularizer over ``aves`` complex channels."""

    def __init__(self, chans: int, pools: int, aves: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dc_weight = nn.Parameter(torch.ones(1))
        self.norm_unet = NormUnet(chans, pools, 2 * aves, dtype=dtype)

    def forward(self, kr, ki, k0r, k0i, sr, si,
                coil: Optional[DataGroup] = None) -> Parts:
        dt = kr.dtype
        dcw = self.dc_weight.to(dt)
        # the sampling mask per component: the reference takes ref != 0 on
        # its (..., 2) pair, i.e. on re and im apart
        dcr = torch.where(k0r != 0, kr - k0r, 0.0) * dcw
        dci = torch.where(k0i != 0, ki - k0i, 0.0) * dcw
        # the cascade's one coil sum; the image and the regularizer are
        # then the same on every coil rank
        xr, xi = sens_reduce_parts(kr, ki, sr, si, coil)
        rr, ri = self.norm_unet(xr[:, None], xi[:, None])
        er, ei = sens_expand_parts(rr[:, 0].to(dt), ri[:, 0].to(dt), sr, si)
        return kr - dcr - er.to(dt), ki - dci - ei.to(dt)


class VarNet(nn.Module):
    """The full network: ``forward(kspace, espirit)`` with k-space ``(b,
    coils, aves, h, w, 2)`` and maps ``(b, coils, sens_aves, h, w, 2)``
    returns ``|image|`` ``(b, aves, h, w)`` in f32. With a ``mesh`` (a
    ``ReconGrid``) both are the global batch and the result is this rank's
    rows of it (module docstring)."""

    def __init__(self, aves: int, sens_aves: int = 1, num_cascades: int = 12,
                 sens_chans: int = 8, sens_pools: int = 4, chans: int = 18,
                 pools: int = 4, dtype: torch.dtype = torch.float32,
                 mesh: Optional[ReconGrid] = None):
        super().__init__()
        self.aves, self.sens_aves = int(aves), int(sens_aves)
        self.dtype = dtype
        self.mesh = mesh
        self.sens_net = SensitivityModel(sens_chans, sens_pools, sens_aves,
                                         dtype=dtype)
        self.cascades = nn.ModuleList([
            VarNetBlock(chans, pools, aves, dtype)
            for _ in range(num_cascades)])

    def forward(self, kspace: torch.Tensor, espirit: torch.Tensor
                ) -> torch.Tensor:
        acc = acc_dtype(self.dtype)
        coil = None
        if self.mesh is not None:
            kspace = shard_dim(kspace, 0, self.mesh.data)
            espirit = shard_dim(espirit, 0, self.mesh.data)
            coil = self.mesh.coil
            if coil is not None and kspace.shape[1] % coil.world:
                coil = None             # uneven coils: replicated, no sums
            kspace = shard_dim(kspace, 1, coil)
            espirit = shard_dim(espirit, 1, coil)
        e32 = espirit.to(acc)
        sr, si = self.sens_net(e32[..., 0], e32[..., 1], coil)
        kr = kspace[..., 0].to(self.dtype).contiguous()
        ki = kspace[..., 1].to(self.dtype).contiguous()
        k0r, k0i = kr, ki
        sr, si = sr.to(self.dtype), si.to(self.dtype)
        for block in self.cascades:
            kr, ki = block(kr, ki, k0r, k0i, sr, si, coil)
        rr, ri = sens_reduce_parts(kr, ki, sr, si, coil)
        rr, ri = rr.to(acc), ri.to(acc)
        return torch.sqrt(rr * rr + ri * ri)


def varnet_layout(state_dict) -> Tuple[int, int]:
    """``(aves, sens_aves)`` of a :class:`VarNet` state_dict, read from its
    first cascade's and its sensitivity network's input widths."""
    key = "unet.conv_blocks.0.convs.0.weight"
    casc = state_dict[f"cascades.0.norm_unet.{key}"]
    sens = state_dict[f"sens_net.norm_unet.{key}"]
    return int(casc.shape[1]) // 2, int(sens.shape[1]) // 2
