"""T2-weighted multi-coil reconstruction (GRAPPA + RSS).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/t2.py:26-181``
(``get_padding``, ``pad_split``, ``zero_pad_kspace``,
``create_coil_combined_im``, ``t2_reconstruction``), after the prostate
code's ``prostate_t2_recon.py``: per-slice GRAPPA weights from the
calibration, averages 0 and 2 filled with the first sampling geometry's
weights and average 1 with the second's; the phase-encode zero-pad of the
ISMRMRD header; the centered iFFT, RSS and ``flipud`` of each slice; the
mean over averages and the centre crop to 320 x 320.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.cpair import to_pair_device
from ..ops.fftc import rss_complex
from ..utils.device import f32_on_card, resolve_device
from .cartesian import center_crop_im, ifftnd_scaled
from .grappa import STAGE_COPIES, Grappa, refuse_mesh

# device bytes a chunk of slices may take in the hole-fill (STAGE_COPIES
# copies of its k-space): 16 GB holds a whole protocol case (10 slices of
# 20 coils at 640 x 368) in one chunk
T2_STAGE_BYTES = 16e9


def get_padding(hdr: str) -> float:
    """Phase-encode padding ``(encodedSpace matrix x - (max PE index + 1))
    / 2`` of an ISMRMRD XML header; namespace-tolerant ElementTree walk,
    with a regex fallback for headers outside the schema."""
    import xml.etree.ElementTree as etree
    try:
        root = etree.fromstring(hdr)
        ns = {"ns": "http://www.ismrm.org/ISMRMRD"}
        lim = root.find("ns:encoding/ns:encodingLimits/"
                        "ns:kspace_encoding_step_1/ns:maximum", ns)
        enc = root.find("ns:encoding/ns:encodedSpace/ns:matrixSize/ns:x", ns)
        if lim is None or enc is None:  # un-namespaced fallback
            lim = root.find("encoding/encodingLimits/"
                            "kspace_encoding_step_1/maximum")
            enc = root.find("encoding/encodedSpace/matrixSize/x")
        return (int(enc.text) - (int(lim.text) + 1)) / 2
    except (etree.ParseError, AttributeError, TypeError, ValueError):
        m = re.findall(r"<x>(\d+)</x>", hdr)
        # the <maximum> of the PE limits block: a full header lists
        # kspace_encoding_step_0 (the readout) first
        mm = re.findall(
            r"kspace_encoding_step_1.*?<maximum>(\d+)</maximum>", hdr,
            re.S)
        if m and mm:
            return (float(m[0]) - (float(mm[0]) + 1)) / 2
        raise ValueError("Could not parse padding from header")


def pad_split(padding: float) -> Tuple[int, int]:
    """``(left, right)`` phase-encode zero-pad: an odd total puts the extra
    zero on the right."""
    if padding % 2 != 0:
        return int(np.floor(padding)), int(np.ceil(padding))
    return int(padding), int(padding)


def zero_pad_kspace(kspace: np.ndarray, padding: float) -> np.ndarray:
    """Zero-pad the last (phase-encode) axis of a host array."""
    left, right = pad_split(padding)
    return np.pad(kspace, [(0, 0)] * (kspace.ndim - 1) + [(left, right)])


def create_coil_combined_im(multicoil_multislice_kspace: np.ndarray,
                            device: str | torch.device = "cuda"
                            ) -> np.ndarray:
    """``(slices, coils, ro, pe)`` k-space -> ``(slices, ro, pe)`` RSS image
    with each slice flipped up-down, computed on ``device``."""
    k = torch.view_as_complex(to_pair_device(
        np.ascontiguousarray(multicoil_multislice_kspace), device=device))
    return rss_complex(ifftnd_scaled(k, [-2, -1]), dim=1).flip(-2).cpu(
    ).numpy()


def _padding(hdr) -> float:
    if hdr is None:
        return 0.0
    if isinstance(hdr, (str, bytes)):
        # h5py hands ISMRMRD headers back as bytes
        return get_padding(hdr.decode() if isinstance(hdr, bytes) else hdr)
    return float(hdr)


def _t2_geometry(kspace_data: np.ndarray, dev: torch.device) -> tuple:
    """The two sampling geometries: average 0's (shared by average 2) and
    average 1's, each from its first slice (host numpy)."""
    return tuple(Grappa(np.transpose(kspace_data[a, 0], (2, 0, 1)),
                        kernel_size=(5, 5), coil_axis=1, device=dev)
                 for a in (0, 1))


def _t2_weights(grappas: tuple, calib_data: np.ndarray) -> tuple:
    """Each geometry's per-slice weights from one Gram stack (it does not
    depend on the geometry)."""
    calib_stack = np.transpose(calib_data, (0, 3, 1, 2))  # (S, pe, C, ro)
    grams = grappas[0].compute_grams(calib_stack)
    return tuple(g.compute_weights_batch(calib_stack, grams=grams)
                 for g in grappas)


def _t2_upload(kspace_data: np.ndarray, transfer_dtype: Optional[str],
               dev: torch.device) -> torch.Tensor:
    """The case's contiguous buffer up once, then reordered on the device
    to ``(avg, slice, pe, coils, ro)``."""
    return torch.view_as_complex(to_pair_device(
        np.ascontiguousarray(kspace_data), transfer_dtype, dev)
    ).permute(0, 1, 4, 2, 3)


def _t2_fill(k: torch.Tensor, grappas: tuple, weights: tuple,
             max_stage_bytes: float) -> torch.Tensor:
    """The hole-fill of ``k`` ``(avg, slice, pe, coils, ro)``: averages 0
    and 2 with the first geometry's weights, average 1 with the second's,
    in chunks of slices; returns ``(3, slice, coils, ro, pe)``."""
    _, num_slices, pe, coils, ro = k.shape
    slice_bytes = 2 * coils * ro * pe * 8              # two averages
    chunk = max(1, int(max_stage_bytes // (slice_bytes * STAGE_COPIES)))
    f02_parts, f1_parts = [], []
    for lo in range(0, num_slices, chunk):
        hi = min(lo + chunk, num_slices)
        f02_parts.append(grappas[0].apply_weights_pair_multi(
            k[0:3:2, lo:hi].transpose(0, 1), weights[0][lo:hi]))
        f1_parts.append(grappas[1].apply_weights_pair_multi(
            k[1:2, lo:hi].transpose(0, 1), weights[1][lo:hi]))
    f02 = torch.cat(f02_parts)                         # (S, 2, pe, C, ro)
    f1 = torch.cat(f1_parts)
    del f02_parts, f1_parts
    return torch.stack([f02[:, 0], f1[:, 0], f02[:, 1]]
                       ).permute(0, 1, 3, 4, 2)        # (3, S, C, ro, pe)


def _t2_image(k_post: torch.Tensor, padding: float) -> torch.Tensor:
    """Phase-encode zero-pad, centered iFFT, RSS, flipud, the mean over
    averages and the crop to 320 x 320, on the device."""
    if padding:
        left, right = pad_split(padding)
        pe = k_post.shape[-1]
        padded = k_post.new_zeros(k_post.shape[:-1] + (pe + left + right,))
        padded[..., left:left + pe] = k_post
        k_post = padded
    img = ifftnd_scaled(k_post, [-2, -1])           # centered iFFT (ro, pe)
    del k_post
    mag = rss_complex(img, dim=2).flip(-2)          # (3, S, ro, pe'), flipud
    del img
    return center_crop_im(mag.mean(dim=0), [320, 320])


def t2_reconstruction(kspace_data: np.ndarray, calib_data: np.ndarray,
                      hdr: Optional[Union[str, bytes, float]] = None,
                      mesh=None, transfer_dtype: Optional[str] = None,
                      device: str | torch.device = "cuda",
                      max_stage_bytes: float = T2_STAGE_BYTES
                      ) -> Dict[str, np.ndarray]:
    """The T2 pipeline on ``device``: ``{"reconstruction_rss": (S, 320,
    320)}`` (or the crop of a smaller image).

    ``kspace_data`` ``(averages=3, slices, coils, ro, pe)`` and
    ``calib_data`` ``(slices, coils, ro, pe_acs)`` are host complex arrays.
    ``hdr`` is an ISMRMRD XML string (or bytes) or an explicit padding;
    None pads nothing. ``transfer_dtype="bfloat16"`` rounds the k-space
    upload to bfloat16 (about 0.4 % relative; the calibration and the
    weight solves stay f32). ``mesh`` is refused (ROADMAP.md Queue 1 item
    7). ``max_stage_bytes`` bounds the device bytes of a chunk of slices in
    the hole-fill.

    The k-space goes up once, as its contiguous buffer, and is reordered
    on the device; the hole-fill, the zero-pad, the iFFT, RSS and flip,
    the mean over averages and the crop stay there, and only the result
    comes back. Matmuls and convolutions run with TF32 off."""
    refuse_mesh(mesh)
    dev = resolve_device(device)
    grappas = _t2_geometry(kspace_data, dev)
    weights = _t2_weights(grappas, calib_data)
    padding = _padding(hdr)
    with f32_on_card(dev):
        k_post = _t2_fill(_t2_upload(kspace_data, transfer_dtype, dev),
                          grappas, weights, max_stage_bytes)
        out = _t2_image(k_post, padding)
        return {"reconstruction_rss": out.cpu().numpy()}
