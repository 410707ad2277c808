"""Optional restoration of the preprocess chain: N4 bias-field correction
and NL-means denoising, batched over the slices of a ``(S, H, W)`` stack.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/ops/restoration.py``:
``gaussian_blur`` (:46), the N4 helpers ``_dft_mats``, ``_hist_conv_pair``,
``_sharpen_expectation`` and ``_spline_smooth`` (:77-165),
``n4_bias_correction`` (:171), ``estimate_sigma`` (:266), ``_patch_sum``
(:279) and ``nl_means_denoise`` (:289). The functions are the same; what
the JAX version runs per slice under ``vmap`` and ``lax.scan`` runs here on
the whole stack, with a per-slice ``done`` flag where the scan carries one.

Where the order of a sum could differ between the CPU and the card, this
module fixes it: stencils and convolutions are sums of shifted slices in
tap order, and the N4 histogram and its convergence statistics accumulate
in float64. So the card and the CPU agree to a few float32 roundings, and
both with the JAX package to the tolerances ``tests/test_torch_restoration.py``
states.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .maskops import otsu_threshold_sorted


# ---------------------------------------------------------------------------
# Padding and separable filtering
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source indices of ``np.pad(x, pad, mode="reflect")`` along an axis of
    size ``n``, for any ``pad``: the reflection repeats with period
    ``2 (n - 1)``, so a pad at least ``n`` wide goes on reflecting (a size
    of 1 repeats its one value), where ``F.pad(mode="reflect")`` raises."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where(j >= n, period - j, j)


def reflect_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """``np.pad(..., mode="reflect")`` of ``x`` by ``pad`` on both ends of
    ``dim``."""
    idx = torch.from_numpy(_reflect_index(x.shape[dim], int(pad))).to(
        x.device)
    return x.index_select(dim, idx)


def _correlate(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """VALID correlation of ``x`` with ``taps`` along ``dim``, summed in tap
    order."""
    n = x.shape[dim] - len(taps) + 1
    out = None
    for t, k in enumerate(taps):
        term = x.narrow(dim, t, n) * float(k)
        out = term if out is None else out + term
    return out


@lru_cache(maxsize=32)
def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of the last two axes (reflect boundary by
    numpy's rule, radius ``max(1, int(3 sigma + 0.5))``), rows first."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gauss_kernel(float(sigma), radius)
    x = _correlate(reflect_pad(img.float(), radius, -2), k, -2)
    return _correlate(reflect_pad(x, radius, -1), k, -1)


# ---------------------------------------------------------------------------
# N4 bias-field correction
# ---------------------------------------------------------------------------

# ITK N4BiasFieldCorrectionImageFilter defaults, as the JAX version takes
# them (restoration.py:64-72).
_N4_ITERS = (50, 50, 30, 20)
_N4_NBINS = 200
_N4_FWHM = 0.15
_N4_WIENER_NOISE = 0.01
_N4_DFT = 512
_N4_BASE_MESH = 1
_N4_CV_STOP = 1e-3


@lru_cache(maxsize=4)
def _dft_mats(n: int):
    """Real and imaginary parts of the ``n``-point DFT matrix, float32 (the
    JAX version's matrices; both are symmetric)."""
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _hist_conv_pair(hist_r, hist_i, ker_r, ker_i, conj_kernel=False):
    """Pointwise complex product in the DFT domain (pairs)."""
    if conj_kernel:
        ker_i = -ker_i
    return (hist_r * ker_r - hist_i * ker_i,
            hist_r * ker_i + hist_i * ker_r)


@lru_cache(maxsize=64)
def _keys_cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of ``jax.image.resize(method="cubic")`` along one
    axis, in float32 as JAX computes them: Keys' kernel with a = -0.5 at
    half-pixel centres, each output's weights renormalised to sum to 1 (so
    the edges need no padding), zero where the sample lies outside the
    input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    kernel_scale = f32(max(float(inv_scale), 1.0))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    near = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    far = ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0)
    w = np.where(x >= 2.0, f32(0.0), np.where(x >= 1.0, far, near)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_cubic(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(img, out_hw, "cubic")`` of the last two axes, as
    two weight-matrix products, the H axis first."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    wh = torch.from_numpy(_keys_cubic_weights(in_h, int(out_hw[0]))).to(
        img.device)
    ww = torch.from_numpy(_keys_cubic_weights(in_w, int(out_hw[1]))).to(
        img.device)
    return torch.matmul(torch.matmul(wh.T, img.float()), ww)


def _sharpen_expectation(u, m, lo, span):
    """One N4 histogram-sharpening step for each slice of ``u`` ``(S, H,
    W)``: Wiener-deconvolve the in-mask log-intensity histogram by the bias
    Gaussian, then map each pixel to its expected unbiased value
    ``E[u_true | u_observed]``. ``lo`` and ``span`` are ``(S,)``."""
    nb, P = _N4_NBINS, _N4_DFT
    s = u.shape[0]
    dev = u.device
    bin_size = span / (nb - 1)
    pos = torch.clamp((u - lo[:, None, None]) / bin_size[:, None, None],
                      0.0, nb - 1.0)
    i0 = torch.clamp(pos.to(torch.int32), 0, nb - 2).to(torch.int64)
    w1 = pos - i0
    flat0 = i0.reshape(s, -1)
    wm = m.reshape(s, -1)
    w1f = w1.reshape(s, -1)
    # fractional (linear) binning; float64 sums, so the order of the
    # card's atomics cannot show
    hist = torch.zeros((s, P), dtype=torch.float64, device=dev)
    hist.scatter_add_(1, flat0, (wm * (1 - w1f)).double())
    hist.scatter_add_(1, flat0 + 1, (wm * w1f).double())
    hist = hist.float()

    # Gaussian kernel in the histogram domain (wrap-around centred at 0)
    sigma_bins = ((_N4_FWHM / bin_size)
                  / np.float32(2.0 * np.sqrt(2.0 * np.log(2.0))))
    x = torch.arange(P, dtype=torch.float32, device=dev)
    d = torch.minimum(x, P - x)
    g = torch.exp(-0.5 * torch.square(
        d / torch.clamp(sigma_bins, min=1e-3)[:, None]))
    g = g / g.sum(dim=1, keepdim=True)

    fr_np, fi_np = _dft_mats(P)
    fr, fi = torch.from_numpy(fr_np).to(dev), torch.from_numpy(fi_np).to(dev)

    def dft(v):
        return v @ fr, v @ fi

    def idft_real(r, i):
        return (r @ fr + i @ fi) / P

    hr, hi = dft(hist)
    gr, gi = dft(g)
    # Wiener deconvolution: H * conj(G) / (|G|^2 + noise)
    denom = gr * gr + gi * gi + _N4_WIENER_NOISE
    nr, ni = _hist_conv_pair(hr, hi, gr, gi, conj_kernel=True)
    sharp = torch.clamp(idft_real(nr / denom, ni / denom), min=0.0)

    # E[u|v]: smooth the sharpened histogram and its first moment back
    # with the same Gaussian, then divide
    centers = lo[:, None] + bin_size[:, None] * x
    d0r, d0i = dft(sharp)
    d1r, d1i = dft(sharp * centers)
    den = idft_real(*_hist_conv_pair(d0r, d0i, gr, gi))
    num = idft_real(*_hist_conv_pair(d1r, d1i, gr, gi))
    e_bins = num / torch.where(den.abs() > 1e-12, den, 1e-12)

    e0 = torch.gather(e_bins, 1, flat0).view_as(u)
    e1 = torch.gather(e_bins, 1, flat0 + 1).view_as(u)
    return e0 * (1 - w1) + e1 * w1


def _spline_smooth(residual, m, h, w, level):
    """Multiresolution field smoothing of each slice: weighted pooling of
    the masked residual onto this level's control grid (``2**level`` cells
    a side), a normalized Gaussian smoothing there, cubic upsampling back."""
    cp = _N4_BASE_MESH * (2 ** level)
    sy = max(1, int(np.ceil(h / cp)))
    sx = max(1, int(np.ceil(w / cp)))
    ph, pw = (-h) % sy, (-w) % sx
    s = residual.shape[0]
    gh, gw = (h + ph) // sy, (w + pw) // sx

    def pool(a):
        a = torch.nn.functional.pad(a, (0, pw, 0, ph))
        return a.reshape(s, gh, sy, gw, sx).sum(dim=(2, 4))

    ctrl = (gaussian_blur(pool(residual * m), 1.0)
            / torch.clamp(gaussian_blur(pool(m), 1.0), min=1e-6))
    return resize_cubic(ctrl, (h + ph, w + pw))[:, :h, :w]


def n4_bias_correction(img: torch.Tensor, mask: torch.Tensor | None = None,
                       max_iterations=_N4_ITERS,
                       return_iterations: bool = False):
    """N4 bias-field correction of each slice of ``img`` ``(S, H, W)``.

    Normalize to [0, 1], take logs, then per level (a) sharpen the in-mask
    log-intensity histogram by Wiener deconvolution with the bias Gaussian
    (FWHM 0.15, noise 0.01, 200 bins), (b) take the residual
    ``u - E[u_true | u]`` as the field update, (c) fit it with a spline
    whose control mesh doubles per level, and accumulate. A level ends for a
    slice after the first update whose ``exp(phi)`` has an in-mask
    coefficient of variation below 1e-3 (the JAX scan's ``done`` carry);
    once every slice is done the level stops. ``mask`` ``(S, H, W)``, or an
    Otsu mask of the normalized image (128 bins) when None; an empty mask
    means the whole slice. The result is rescaled to the input's range.
    Returns float32 ``(S, H, W)``, and with ``return_iterations`` also the
    int32 ``(S, levels)`` count of updates each level applied."""
    x = img.float()
    s, h, w = x.shape
    lo_i = x.amin(dim=(1, 2), keepdim=True)
    hi_i = x.amax(dim=(1, 2), keepdim=True)
    rng_ = hi_i - lo_i + 1e-8
    norm = (x - lo_i) / rng_
    if mask is None:
        th = otsu_threshold_sorted(torch.sort(norm.reshape(s, -1),
                                              dim=1).values, nbins=128)
        m = (norm > th[:, None, None]).float()
    else:
        m = (mask > 0).float()
    m = torch.where(m.sum(dim=(1, 2), keepdim=True) > 0, m,
                    torch.ones_like(norm))
    u0 = torch.log(norm + 1e-4)
    msum = torch.clamp(m.double().sum(dim=(1, 2)), min=1.0)
    inside = m > 0
    f_total = torch.zeros_like(u0)
    counts = []
    for level, iters in enumerate(max_iterations):
        done = torch.zeros(s, dtype=torch.bool, device=x.device)
        applied = torch.zeros(s, dtype=torch.int32, device=x.device)
        for _ in range(int(iters)):
            u_cur = u0 - f_total
            # histogram range over the current in-mask log intensities
            lo = torch.where(inside, u_cur, torch.inf).amin(dim=(1, 2))
            hi = torch.where(inside, u_cur, -torch.inf).amax(dim=(1, 2))
            span = torch.clamp(hi - lo, min=1e-6)
            e = _sharpen_expectation(u_cur, m, lo, span)
            phi = _spline_smooth(u_cur - e, m, h, w, level)
            ratio = torch.exp(phi).double()
            md = m.double()
            mu = (ratio * md).sum(dim=(1, 2)) / msum
            sd = torch.sqrt(torch.square((ratio - mu[:, None, None]) * md
                                         ).sum(dim=(1, 2)) / msum)
            cv = sd / torch.clamp(mu, min=1e-6)
            f_total = torch.where(done[:, None, None], f_total,
                                  f_total + phi)
            applied += (~done).to(torch.int32)
            done = done | (cv < _N4_CV_STOP)
            if bool(done.all()):
                break
        counts.append(applied)

    out = torch.clamp(torch.exp(u0 - f_total) - 1e-4, min=0.0)
    omin = out.amin(dim=(1, 2), keepdim=True)
    omax = out.amax(dim=(1, 2), keepdim=True)
    out01 = (out - omin) / torch.clamp(omax - omin, min=1e-8)
    out = (out01 * rng_ + lo_i).float()
    if return_iterations:
        return out, torch.stack(counts, dim=1)
    return out


# ---------------------------------------------------------------------------
# NL-means denoising
# ---------------------------------------------------------------------------

# Daubechies-2 decomposition high-pass (pywt db2 dec_hi), the wavelet of
# skimage's estimate_sigma, and the MAD -> sigma constant it uses.
_DB2_HI = np.array([-0.48296291314469025, 0.836516303737469,
                    -0.22414386804185735, 0.12940952255092145], np.float64)
_MAD_TO_SIGMA = 0.6744897501960817


def _db2_highpass_downsample(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One pywt-style DWT high-pass along ``dim``: symmetric extension by
    3, convolution with dec_hi, the odd phase of a stride-2 downsample."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    ext = torch.cat([x[..., :3].flip(-1), x, x[..., n - 3:].flip(-1)],
                    dim=-1)[..., 1:]
    k = _DB2_HI[::-1].astype(np.float32)
    length = (ext.shape[-1] - len(k)) // 2 + 1
    out = None
    for t, kt in enumerate(k):
        term = ext[..., t:t + 2 * (length - 1) + 1:2] * float(kt)
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def _median_last(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle values
    of an even count (``torch.median`` would return the lower one)."""
    srt = torch.sort(v, dim=-1).values
    n = srt.shape[-1]
    if n % 2:
        return srt[..., n // 2]
    return (srt[..., n // 2 - 1] + srt[..., n // 2]) * 0.5


def estimate_sigma(img: torch.Tensor) -> torch.Tensor:
    """Noise std of each ``(H, W)`` image of ``img``: Donoho's MAD over the
    first-level db2 diagonal detail, ``median(|HH|) / 0.6745``. Returns
    ``img.shape[:-2]``."""
    x = img.float()
    hh = _db2_highpass_downsample(_db2_highpass_downsample(x, -2), -1)
    return _median_last(hh.abs().flatten(-2)) / _MAD_TO_SIGMA


def _patch_sum(img: torch.Tensor, patch: int) -> torch.Tensor:
    """Sum over a ``patch x patch`` window (reflect-padded) of each pixel of
    the last two axes, in tap order."""
    r = patch // 2
    xp = reflect_pad(reflect_pad(img, r, -2), r, -1)
    h, w = img.shape[-2], img.shape[-1]
    out = None
    for dy in range(patch):
        for dx in range(patch):
            tap = xp[..., dy:dy + h, dx:dx + w]
            out = tap if out is None else out + tap
    return out


def nl_means_denoise(img: torch.Tensor, h=None, patch_size: int = 3,
                     patch_distance: int = 5, sigma=None) -> torch.Tensor:
    """Fast NL-means of each ``(H, W)`` slice of ``img`` ``(S, H, W)`` with
    the reference's parameters: ``sigma = estimate_sigma(slice)``, ``h = 0.8
    sigma`` (0.01 where sigma is 0), patch 3, search distance 5. The weight
    of the neighbour at offset t is ``exp(-max(D_t - 2 sigma^2, 0) / h^2)``
    with ``D_t`` the patch-mean squared difference; the offsets are taken in
    the JAX version's order. ``h`` and ``sigma`` may be numbers or ``(S,)``
    tensors."""
    x = img.float()
    s = x.shape[0]
    if sigma is None:
        sigma = estimate_sigma(x)
    sigma = torch.as_tensor(sigma, dtype=torch.float32,
                            device=x.device).expand(s)
    if h is None:
        h = torch.where(sigma > 0, 0.8 * sigma, 0.01)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device).expand(s)
    d = int(patch_distance)
    npx = float(patch_size * patch_size)
    var2 = (2.0 * sigma * sigma)[:, None, None]
    hh = torch.clamp(h * h, min=1e-12)[:, None, None]
    ip = reflect_pad(reflect_pad(x, d, -2), d, -1)
    H, W = x.shape[-2], x.shape[-1]
    wsum = torch.ones_like(x)
    acc = x * 1.0
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if (dy, dx) == (0, 0):
                continue
            shifted = ip[:, d + dy:d + dy + H, d + dx:d + dx + W]
            dist = _patch_sum((x - shifted) ** 2, patch_size) / npx
            wt = torch.exp(-torch.clamp(dist - var2, min=0.0) / hh)
            wsum = wsum + wt
            acc = acc + wt * shifted
    return (acc / wsum).float()
