"""Parity of the PyTorch port's k-space and image ops with the JAX package.

Same seeded numpy inputs through both; tolerances rtol = atol = 1e-5 (f32
arithmetic in another order: pocketfft vs the DFT matmul, BLAS vs XLA dot
sums, another reduction order in the z-score).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mri_acl_imagesegmentation_adsp_tpu.ops import fftc as jfftc
from mri_acl_imagesegmentation_adsp_tpu.ops import imageops as jimg
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import fftc, imageops
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "preprocess_goldens.npz"


def test_ifft2c_magnitude_matches_jax():
    pair = synthetic_kspace_pairs(seed=3, s=3, h=64, w=48)
    want = np.asarray(jfftc.ifft2c_magnitude(jnp.asarray(pair)))
    got = fftc.ifft2c_magnitude(torch.from_numpy(pair)).numpy()
    assert got.shape == (3, 64, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    cplx = torch.view_as_complex(torch.from_numpy(pair))
    np.testing.assert_array_equal(fftc.ifft2c_magnitude(cplx).numpy(), got)
    with pytest.raises(ValueError):
        fftc.ifft2c_magnitude(torch.zeros(4, 4, 3))


@pytest.mark.parametrize("q", [0.0, 1.0, 37.3, 50.0, 99.5, 100.0])
def test_quantile_from_sorted_and_clip_match_jax(rng, q):
    x = np.sort(rng.standard_normal((3, 1001)).astype(np.float32), axis=1)
    want = np.asarray(jimg.quantile_from_sorted(jnp.asarray(x), q))
    got = imageops.quantile_from_sorted(torch.from_numpy(x), q).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.percentile(x, q, axis=1), **TOL)
    lo = imageops.quantile_from_sorted(torch.from_numpy(x), 1.0)[:, None]
    hi = imageops.quantile_from_sorted(torch.from_numpy(x), 99.5)[:, None]
    clipped = torch.clamp(torch.from_numpy(x), lo, hi).numpy()
    want_clip = np.stack([np.asarray(jimg.percentile_clip(
        jnp.asarray(r), 1.0, 99.5)) for r in x])
    np.testing.assert_allclose(clipped, want_clip, **TOL)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 48), (32, 32)),
                                          ((128, 128), (96, 80)),
                                          ((33, 17), (40, 50)),
                                          ((20, 20), (20, 20))])
def test_resize_bilinear_matches_jax_and_torch(rng, in_hw, out_hw):
    img = rng.random((2,) + in_hw).astype(np.float32)
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(img), out_hw))
    got = imageops.resize_bilinear(torch.from_numpy(img), out_hw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = F.interpolate(torch.from_numpy(img)[:, None], size=out_hw,
                        mode="bilinear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_resize_matches_frozen_goldens():
    z = np.load(GOLDENS)
    for i in range(8):
        got = imageops.resize_bilinear(torch.from_numpy(z[f"img_{i}"]),
                                       (96, 80)).numpy()
        np.testing.assert_allclose(got, z[f"resize_{i}"], **TOL)


def _mask_cases(rng):
    img = rng.random((4, 40, 30)).astype(np.float32) * 5
    mask = np.zeros((4, 40, 30), np.uint8)
    mask[0, 5:30, 4:20] = 1                    # ordinary in-mask stats
    mask[1, 3, 3:9] = 1                        # < 10 pixels: whole image
    img[2] = 2.5                               # constant: std -> 1
    mask[2, 10:20, 10:20] = 1
    return img, mask                           # slice 3: empty mask


def test_zscore_in_mask_matches_jax(rng):
    img, mask = _mask_cases(rng)
    got = imageops.zscore_in_mask(torch.from_numpy(img),
                                  torch.from_numpy(mask)).numpy()
    for s in range(img.shape[0]):
        want = np.asarray(jimg.zscore_in_mask(jnp.asarray(img[s]),
                                              jnp.asarray(mask[s])))
        np.testing.assert_allclose(got[s], want, **TOL)


def test_preview_01_matches_jax(rng):
    img, mask = _mask_cases(rng)
    got = imageops.preview_01(torch.from_numpy(img),
                              torch.from_numpy(mask)).numpy()
    for s in range(img.shape[0]):
        want = np.asarray(jimg.preview_01(jnp.asarray(img[s]),
                                          jnp.asarray(mask[s])))
        np.testing.assert_allclose(got[s], want, **TOL)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("shape", [(2, 16, 12), (3, 2, 15, 9)])
def test_centered_ffts_and_pairs_match_jax(rng, shape):
    """fft2c / ifft2c on complex tensors, their real-pair forms, and
    complex_abs, against the JAX DFT matmuls at HIGHEST precision."""
    x = _cplx(rng, shape)
    pair = np.stack([x.real, x.imag], -1).astype(np.float32)
    for jfn, fn, pfn, jpfn in ((jfftc.fft2c, fftc.fft2c, fftc.fft2c_pair,
                                jfftc.fft2c_pair),
                               (jfftc.ifft2c, fftc.ifft2c, fftc.ifft2c_pair,
                                jfftc.ifft2c_pair)):
        want = np.asarray(jfn(jnp.asarray(x)))
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                                   **TOL)
        got_pair = pfn(torch.from_numpy(pair)).numpy()
        np.testing.assert_allclose(got_pair,
                                   np.asarray(jpfn(jnp.asarray(pair))), **TOL)
        assert got_pair.shape == pair.shape
    np.testing.assert_allclose(
        fftc.ifft2c(fftc.fft2c(torch.from_numpy(x))).numpy(), x, **TOL)
    np.testing.assert_allclose(
        fftc.complex_abs(torch.from_numpy(x)).numpy(),
        np.asarray(jfftc.complex_abs(jnp.asarray(x))), **TOL)
    r = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(fftc.complex_abs(torch.from_numpy(r)
                                                   ).numpy(), np.abs(r))


def test_rss_and_rss_complex_match_jax(rng):
    """Multi-coil coil combination: RSS over the coil axis of complex
    images and of their (..., 2) pairs (the pair's axis counts the (C, H,
    W) layout); and the chain's form, per-coil iFFT then RSS."""
    x = _cplx(rng, (2, 5, 16, 12))
    pair = np.stack([x.real, x.imag], -1).astype(np.float32)
    for dim in (0, 1):
        want = np.asarray(jfftc.rss_complex(jnp.asarray(x), axis=dim))
        np.testing.assert_allclose(
            fftc.rss_complex(torch.from_numpy(x), dim=dim).numpy(), want,
            **TOL)
        np.testing.assert_allclose(
            fftc.rss_complex(torch.from_numpy(pair), dim=dim).numpy(),
            np.asarray(jfftc.rss_complex(jnp.asarray(pair), axis=dim)),
            **TOL)
    r = x.real.astype(np.float32)
    np.testing.assert_allclose(fftc.rss(torch.from_numpy(r), 1).numpy(),
                               np.asarray(jfftc.rss(jnp.asarray(r), 1)),
                               **TOL)
    want = np.stack([np.asarray(jfftc.rss_complex(jfftc.ifft2c_pair(
        jnp.asarray(pair[s])), axis=0)) for s in range(2)])
    got = fftc.rss_complex(fftc.ifft2c(torch.from_numpy(x)), dim=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError):
        fftc.rss_complex(torch.zeros(2, 3, 3))


@pytest.mark.parametrize("out_hw", [(8, 6), (20, 15), (8, 15), (13, 9),
                                    (11, 10)])
def test_center_crop_or_pad_matches_jax(rng, out_hw):
    img = rng.standard_normal((2, 11, 10)).astype(np.float32)
    got = fftc.center_crop_or_pad(torch.from_numpy(img), *out_hw).numpy()
    want = np.asarray(jfftc.center_crop_or_pad(jnp.asarray(img), *out_hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pmin,pmax", [(1.0, 99.5), (0.0, 100.0),
                                       (5.0, 50.0)])
def test_percentile_and_percentile_clip_match_jax(rng, pmin, pmax):
    imgs = rng.standard_normal((3, 33, 21)).astype(np.float32)
    got = imageops.percentile_clip(torch.from_numpy(imgs), pmin, pmax)
    for s in range(3):
        want = np.asarray(jimg.percentile_clip(jnp.asarray(imgs[s]), pmin,
                                               pmax))
        np.testing.assert_allclose(got[s].numpy(), want, **TOL)
    np.testing.assert_allclose(
        float(imageops.percentile(torch.from_numpy(imgs), pmax)),
        float(jimg.percentile(jnp.asarray(imgs), pmax)), **TOL)


def test_to_pair_np_matches_jax(rng):
    from mri_acl_imagesegmentation_adsp_tpu.ops.cpair import to_pair_np
    x = _cplx(rng, (3, 4, 5))
    np.testing.assert_array_equal(fftc.to_pair_np(x), to_pair_np(x))
    r = rng.standard_normal((4, 5))
    np.testing.assert_array_equal(fftc.to_pair_np(r), to_pair_np(r))
