"""Diffusion-weighted (DWI) reconstruction.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/dwi.py:46-343``,
after the prostate code's ``reconstruction/dwi/``: EPI trapezoidal
regridding, per-slice GRAPPA, the conjugate-sensitivity coil combine, the
b50 / b1000 direction averages, and the trace, ADC and computed-b1500
maps. ``get_grid_mat``, ``_ramp_trajectory`` and the diffusion metrics are
host numpy in the JAX package too, and are copied here verbatim; the regrid
is one f32 matmul over the whole stack on the device, and the GRAPPA fill,
iFFT, coil combine and magnitude stay on the device until one download.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cpair import to_complex, to_pair_device
from ..ops.fftc import complex_abs
from ..utils.device import f32_on_card, resolve_device
from .cartesian import center_crop_im, flip_im, ifftnd_scaled
from .grappa import STAGE_COPIES, Grappa, refuse_mesh

# EPI readout constants of the fastMRI-prostate acquisition: ADC samples
# and ADC duration in us
_ADC_SAMPLES = 200
_ADC_DURATION_US = 580.0

# device bytes a chunk of slices may take in the hole-fill (STAGE_COPIES
# copies of its k-space): 8 GB holds a protocol case of 8 slices of 51
# averages x 12 coils at 200 x 104 in one chunk
DWI_STAGE_BYTES = 8e9


# ---------------------------------------------------------------------------
# Trapezoidal regridding
# ---------------------------------------------------------------------------

def _ramp_trajectory(t: np.ndarray, rampup: float, flattop: float,
                     rampdown: float) -> np.ndarray:
    """k-space position against time under a trapezoidal readout gradient:
    quadratic on the ramp up, linear on the flat top, and the flat top's
    line less a quadratic on the ramp down."""
    k_rampup = 0.5 * np.square(np.minimum(t, rampup)) / rampup
    k_flat = np.clip(t - rampup, 0.0, None)
    t_down = np.clip(t - rampup - flattop, 0.0, None)
    k_down = -0.5 * np.square(t_down) / rampdown
    return k_rampup + k_flat + k_down


def get_grid_mat(epi_params: Dict, os_factor: float = 2,
                 keep_oversampling: bool = True) -> np.ndarray:
    """Sinc-interpolation gridding matrix for EPI ramp sampling: rows are
    the uniform targets, columns the acquired samples, entries density-
    compensated sinc weights, each row normalized to unit sum."""
    rampup = epi_params["rampUpTime"]
    rampdown = epi_params["rampDownTime"]
    flattop = epi_params["flatTopTime"]
    delay = epi_params["acqDelayTime"]

    n_src = _ADC_SAMPLES
    n_dst = n_src if keep_oversampling else int(n_src / os_factor)
    if rampup == 0:
        return np.eye(n_dst, n_src)

    t = np.linspace(delay, delay + _ADC_DURATION_US, n_src)
    k_acq = _ramp_trajectory(t, rampup, flattop, rampdown)
    # centred on the sample just left of the midpoint
    k_acq = k_acq - k_acq[n_src // 2 - 1]

    k_unif = np.linspace(k_acq[0], k_acq[-1], n_dst)
    spacing = k_unif[1] - k_unif[0]

    # sample density = local k-step (the last sample reuses the first's)
    density = np.diff(k_acq, append=np.nan)
    density[-1] = density[0]

    mat = np.sinc((k_unif[:, None] - k_acq[None, :]) / spacing) * density
    return mat / (1e-12 + mat.sum(axis=1, keepdims=True))


def _regrid_pair_device(k_pair: torch.Tensor,
                        grid_mat: np.ndarray) -> torch.Tensor:
    """Regrid a ``(..., ro, pe, 2)`` real-pair stack along the readout
    axis: one f32 matmul for the whole stack, both pair components
    together, with TF32 off."""
    g = torch.from_numpy(np.asarray(grid_mat, np.float32)).to(k_pair.device)
    with f32_on_card(k_pair.device):
        return torch.einsum("or,...rpt->...opt", g, k_pair)


def trapezoidal_regridding(img: np.ndarray, epi_params: Dict,
                           device: str | torch.device = "cuda"
                           ) -> np.ndarray:
    """Regrid ``(coils, ro, pe)`` complex k-space along the readout axis on
    ``device``; host complex64 out."""
    grid_mat = get_grid_mat(epi_params).astype(np.float32)
    return to_complex(_regrid_pair_device(to_pair_device(
        np.ascontiguousarray(img), device=device), grid_mat))


# ---------------------------------------------------------------------------
# Direction averages and diffusion metrics (host numpy)
# ---------------------------------------------------------------------------

def _direction_indices(axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Acquisition indices of diffusion direction ``axis`` (0=x, 1=y, 2=z)
    in the 50-average fastMRI-prostate protocol: 4 b50 and 12 b1000 NEX a
    direction."""
    b50 = np.arange(2 + axis, 21 + axis, 6)
    b1000 = np.concatenate([np.arange(5 + axis, 24 + axis, 6),
                            np.arange(26 + axis, 48 + axis, 3)])
    return b50, b1000


def compute_averages(img_vol: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-direction b50 / b1000 NEX means of the ``(averages, ...)``
    stack."""
    out: Dict[str, np.ndarray] = {}
    for j, name in enumerate("xyz"):
        b50_idx, b1000_idx = _direction_indices(j)
        out[f"b50{name}"] = img_vol[b50_idx].mean(axis=0)
        out[f"b1000{name}"] = img_vol[b1000_idx].mean(axis=0)
    return out


def trace(img_dict: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Isotropic trace images: the geometric mean of the three directions
    at each b-value."""
    def geo_mean3(a, b, c):
        return np.cbrt(a * b * c)
    return (geo_mean3(img_dict["b50x"], img_dict["b50y"], img_dict["b50z"]),
            geo_mean3(img_dict["b1000x"], img_dict["b1000y"],
                      img_dict["b1000z"]))


def _fit_adc_volume(stack: np.ndarray, adc_scale: float,
                    b_values: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form log-linear diffusion fit of a whole volume.

    ``stack``: ``(S, H, W, directions, 2)`` direction images at the two
    b-values. With two b-values the least-squares line through ``(b,
    mean_dirs log(S_b + 1))`` is exactly determined."""
    b_lo, b_hi = float(b_values[0]), float(b_values[-1])
    # per-slice intensity rescale, as the prostate code's per-slice calls
    mean_per_slice = stack.mean(axis=(1, 2, 3, 4), keepdims=True)
    scaled = np.where(mean_per_slice < 1e-3, 1e5 * stack, stack)
    log_mean = np.log(scaled + 1.0).mean(axis=3)       # (S, H, W, 2)

    y_lo, y_hi = log_mean[..., 0], log_mean[..., 1]
    slope = (y_hi - y_lo) / (b_hi - b_lo)
    intercept = y_lo - slope * b_lo

    b0_img = np.exp(intercept)
    b0_img[np.isnan(b0_img)] = 0
    adc_map = slope * adc_scale
    adc_map[(adc_map < 0) | np.isnan(adc_map)] = 0
    return adc_map, b0_img


def adc(raw_images: np.ndarray, adc_scale: float, b_values: List[int]
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Single-slice ADC fit: ``(H, W, directions, 2)`` -> ``(adc_map,
    b0_img)``, through the whole-volume fit."""
    adc_map, b0_img = _fit_adc_volume(raw_images[None], adc_scale, b_values)
    return adc_map[0], b0_img[0]


def b1500(adc_map: np.ndarray, b0_img: np.ndarray, adc_scale: float,
          b_values: List[int]) -> np.ndarray:
    """Computed (extrapolated) b1500 image: pixels whose b0 lies below the
    noise floor take a noise-model ADC offset before the extrapolation."""
    target_b = 1500.0
    floor = 12.0                    # default noise level and b0 threshold
    max_adc_for_noise = 300.0       # ADC band considered noise-like
    offset_scale = 1000.0           # noise-model ADC offset magnitude
    min_pixel_fraction = 0.01

    # data-driven noise floor: 3x the median b0 over noise-like pixels,
    # where there are enough of them
    noise_like = b0_img[(adc_map < max_adc_for_noise) & (b0_img > floor)]
    if noise_like.size > min_pixel_fraction * adc_map.size + 1:
        floor = 3.0 * np.median(noise_like)

    below = (floor > 0) & (b0_img < floor)
    rel = np.square(np.where(below, b0_img, 0.0) / max(floor, 1e-30))
    adc_floor = np.where(
        below, offset_scale * np.sqrt(np.maximum(1.0 - rel, 0.0)), 0.0)

    extrap = (target_b - b_values[-1]) / adc_scale
    decay = b_values[-1] / adc_scale
    exponent = extrap * np.maximum(adc_map, adc_floor) + decay * adc_map
    return b0_img * np.exp(exponent)


def compute_trace_adc_b1500(img_dict: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
    """Trace, ADC and computed-b1500 maps from the direction averages,
    added to ``img_dict``."""
    img_dict["trace_b50"], img_dict["trace_b1000"] = trace(img_dict)

    adc_scale = -1e+6
    b_values = [50, 1000]
    # (S, H, W, direction, b-value) stack for the whole-volume fit
    stack = np.stack([
        np.stack([img_dict[f"b{b}{name}"] for b in b_values], axis=-1)
        for name in "xyz"], axis=-2)
    adc_map, b0_img = _fit_adc_volume(stack, adc_scale, b_values)

    img_dict["adc_map"] = adc_map
    img_dict["b1500"] = b1500(adc_map, b0_img, adc_scale, b_values)
    return img_dict


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _dwi_weights(kspace: np.ndarray, calibration: np.ndarray, hdr: Dict,
                 grid_mat: np.ndarray, dev: torch.device) -> tuple:
    """``(grappa, per-slice weights)``: the kernel geometry from one
    regridded slice's sampling pattern, and every slice's calibration
    regridded in one matmul and solved in one batched call."""
    pattern_slice = trapezoidal_regridding(kspace[0, 0], hdr, device=dev)
    grappa = Grappa(np.transpose(pattern_slice, (2, 0, 1)),  # (pe, C, ro)
                    kernel_size=(5, 5), coil_axis=1, device=dev)
    calib_rg = to_complex(_regrid_pair_device(to_pair_device(
        np.ascontiguousarray(calibration), device=dev), grid_mat))
    return grappa, grappa.compute_weights_batch(
        np.transpose(calib_rg, (0, 3, 1, 2)))


def _dwi_upload(kspace: np.ndarray, grid_mat: np.ndarray,
                transfer_dtype: Optional[str], dev: torch.device
                ) -> torch.Tensor:
    """The k-space up once and regridded in one matmul, as ``(A, S, pe, C,
    ro')`` complex on the device."""
    k_rg = _regrid_pair_device(to_pair_device(
        np.ascontiguousarray(kspace), transfer_dtype, dev), grid_mat)
    return torch.view_as_complex(k_rg).permute(0, 1, 4, 2, 3)


def _dwi_magnitudes(k_g: torch.Tensor, coil_sens_maps: np.ndarray,
                    grappa: Grappa, weights: list,
                    max_stage_bytes: float) -> np.ndarray:
    """GRAPPA, iFFT, the conjugate-sensitivity combine and the magnitude in
    chunks of slices on the device; one ``(A, S, ro, pe)`` float32
    download."""
    n_avg, n_slices, n_pe, n_coils, n_ro = k_g.shape
    sens_conj = torch.view_as_complex(to_pair_device(
        np.ascontiguousarray(coil_sens_maps), device=k_g.device)).conj()
    slice_bytes = n_avg * n_coils * n_ro * n_pe * 8
    chunk = max(1, int(max_stage_bytes // (slice_bytes * STAGE_COPIES)))
    mags = []
    for s_lo in range(0, n_slices, chunk):
        s_hi = min(s_lo + chunk, n_slices)
        filled = grappa.apply_weights_pair_multi(
            k_g[:, s_lo:s_hi].transpose(0, 1),
            weights[s_lo:s_hi])                    # (cs, A, pe, C, ro)
        img = ifftnd_scaled(filled.permute(1, 0, 3, 4, 2), [-2, -1])
        comb = torch.sum(img * sens_conj[None, s_lo:s_hi], dim=2)
        mags.append(complex_abs(comb))             # (A, cs, ro, pe)
    return torch.cat(mags, dim=1).cpu().numpy()


def _dwi_maps(img_vol: np.ndarray) -> Dict[str, np.ndarray]:
    """Direction averages, trace, ADC and b1500 on the host, each flipped
    and cropped to 100 x 100."""
    img_dict = compute_trace_adc_b1500(compute_averages(img_vol))
    crop = (100, 100)
    return {key: center_crop_im(flip_im(im, 0), crop)
            for key, im in img_dict.items()}


def dwi_reconstruction(kspace: np.ndarray, calibration: np.ndarray,
                       coil_sens_maps: np.ndarray, hdr: Dict,
                       max_stage_bytes: float = DWI_STAGE_BYTES,
                       mesh=None,
                       transfer_dtype: Optional[str] = None,
                       device: str | torch.device = "cuda"
                       ) -> Dict[str, np.ndarray]:
    """Regrid -> GRAPPA -> iFFT -> coil combine -> direction averages ->
    trace / ADC / b1500 -> flip and centre crop to 100 x 100.

    Layouts: ``kspace`` ``(averages, slices, coils, ro, pe)``,
    ``calibration`` and ``coil_sens_maps`` ``(slices, coils, ro, pe)``;
    ``hdr`` the EPI timing (``data/recon_data.py:get_regridding_params``).
    The k-space goes up once and is regridded in one matmul; GRAPPA fills
    all averages of a chunk of slices (``max_stage_bytes`` bounds its device
    bytes) in one grouped convolution a geometry; the iFFT, the combine
    with the conjugate sensitivities and the magnitude stay on ``device``,
    and one float32 ``(averages, slices, ro, pe)`` volume comes back for
    the host metrics. ``transfer_dtype="bfloat16"`` rounds the k-space
    upload (the calibration and the sensitivities stay f32); ``mesh`` is
    refused (ROADMAP.md Queue 1 item 7)."""
    refuse_mesh(mesh)
    dev = resolve_device(device)
    grid_mat = get_grid_mat(hdr).astype(np.float32)
    grappa, weights = _dwi_weights(kspace, calibration, hdr, grid_mat, dev)
    with f32_on_card(dev):
        img_vol = _dwi_magnitudes(
            _dwi_upload(kspace, grid_mat, transfer_dtype, dev),
            coil_sens_maps, grappa, weights, max_stage_bytes)
    return _dwi_maps(img_vol)
