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
