"""Parity of the PyTorch port's restoration ops (``ops/restoration.py``)
with the JAX package's, at 32-48 px.

The same seeded numpy inputs go through the JAX function, called eagerly
(no jit: the 120-offset NL-means stencil and N4's scans would compile for
minutes), and the port's, batched over slices. Tolerances, with reasons:
- reflect padding, the Gaussian blur, the cubic resize weights and the db2
  detail: 1e-6 (float32 sums of a few taps in another order);
- estimate_sigma: 1e-6 relative (a median of those details);
- NL-means: 5e-6 (120 exponentials of distances that differ by roundings;
  7e-7 measured);
- N4: 2e-5 of the input's range (4e-7 measured). It iterates up to 150
  times and stops a level where a coefficient of variation crosses 1e-3;
  the port sums its histogram and the statistics of that test in float64,
  JAX in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.ops import restoration as jr
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import restoration as rs

N4_TOL = 2e-5     # of the input's range
NLM_TOL = 5e-6


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 3), (3, 3), (4, 3), (5, 2),
                                   (8, 3), (9, 5)])
def test_reflect_pad_is_numpys_rule(n, pad):
    """``np.pad(mode="reflect")`` for every pad, also past the size, where
    ``F.pad`` raises: a 1x1 grid stays constant, ``[1, 2]`` by 3 gives
    ``2 1 2 1 2 1 2 1``."""
    x = np.arange(1, n + 1, dtype=np.float32)
    got = rs.reflect_pad(torch.from_numpy(x), pad, 0).numpy()
    np.testing.assert_array_equal(got, np.pad(x, pad, mode="reflect"))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.pad(jnp.asarray(x), pad, mode="reflect")))
    if n == 2 and pad == 3:
        np.testing.assert_array_equal(got, [2, 1, 2, 1, 2, 1, 2, 1])


@pytest.mark.parametrize("shape,sigma", [((1, 1), 1.0), ((2, 2), 1.0),
                                         ((4, 4), 1.0), ((8, 8), 1.0),
                                         ((33, 40), 1.0), ((48, 36), 2.0)])
def test_gaussian_blur_matches_jax(rng, shape, sigma):
    imgs = rng.standard_normal((3,) + shape).astype(np.float32)
    got = rs.gaussian_blur(torch.from_numpy(imgs), sigma).numpy()
    for s in range(3):
        want = np.asarray(jr.gaussian_blur(jnp.asarray(imgs[s]), sigma))
        np.testing.assert_allclose(got[s], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_hw,out_hw", [((1, 1), (40, 36)),
                                          ((2, 2), (40, 36)),
                                          ((8, 8), (640, 368)),
                                          ((5, 3), (5, 3))])
def test_resize_cubic_matches_jax(rng, in_hw, out_hw):
    import jax
    img = rng.standard_normal((2,) + in_hw).astype(np.float32)
    got = rs.resize_cubic(torch.from_numpy(img), out_hw).numpy()
    for s in range(2):
        want = np.asarray(jax.image.resize(jnp.asarray(img[s]), out_hw,
                                           method="cubic"))
        np.testing.assert_allclose(got[s], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(32, 32), (33, 47), (48, 40)])
def test_estimate_sigma_matches_jax(rng, shape):
    """33x47 gives 18x25 = 450 db2 details, an even count, where the
    median is the mean of the two middles as jnp.median takes it; 32x32 and
    48x40 give odd counts (289, 525), where it is the middle one."""
    imgs = (rng.standard_normal((3,) + shape) * 0.1
            + 1.0).astype(np.float32)
    got = rs.estimate_sigma(torch.from_numpy(imgs)).numpy()
    want = np.array([float(jr.estimate_sigma(jnp.asarray(i))) for i in imgs])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    hh = rs._db2_highpass_downsample(rs._db2_highpass_downsample(
        torch.from_numpy(imgs), -2), -1).numpy()
    want_hh = np.asarray(jr._db2_highpass_downsample(
        jr._db2_highpass_downsample(jnp.asarray(imgs[0]), 0), 1))
    np.testing.assert_allclose(hh[0], want_hh, rtol=1e-6, atol=1e-6)


def test_median_of_an_even_count_averages_the_middles():
    v = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(rs._median_last(v)[0]) == 2.5
    assert float(jnp.median(jnp.asarray([4.0, 1.0, 3.0, 2.0]))) == 2.5
    assert float(torch.median(v)) == 2.0   # why the port does not use it


@pytest.mark.parametrize("case", ["random", "disk", "constant"])
def test_nl_means_matches_jax(rng, case):
    yy, xx = np.mgrid[:40, :36].astype(np.float32)
    if case == "random":
        imgs = (rng.standard_normal((2, 40, 36)) * 0.3 + 1.0)
    elif case == "disk":
        clean = (np.hypot(yy - 20, xx - 18) < 12).astype(np.float32)
        imgs = clean + rng.normal(0, 0.1, (2, 40, 36))
    else:
        imgs = np.full((2, 40, 36), 2.5)
    imgs = imgs.astype(np.float32)
    kw = {"sigma": 0.0} if case == "constant" else {}
    got = rs.nl_means_denoise(torch.from_numpy(imgs), **kw).numpy()
    for s in range(2):
        want = np.asarray(jr.nl_means_denoise(jnp.asarray(imgs[s]), **kw))
        np.testing.assert_allclose(got[s], want, rtol=NLM_TOL, atol=NLM_TOL)
    if case == "constant":
        np.testing.assert_allclose(got, imgs, atol=1e-5)


def test_nl_means_takes_h_and_sigma_per_slice(rng):
    imgs = (rng.standard_normal((2, 32, 32)) * 0.3 + 1.0).astype(np.float32)
    sig = torch.tensor([0.1, 0.2])
    got = rs.nl_means_denoise(torch.from_numpy(imgs), h=0.8 * sig,
                              sigma=sig).numpy()
    for s in range(2):
        want = np.asarray(jr.nl_means_denoise(
            jnp.asarray(imgs[s]), h=0.8 * float(sig[s]),
            sigma=float(sig[s])))
        np.testing.assert_allclose(got[s], want, rtol=NLM_TOL, atol=NLM_TOL)


def _biased(rng, h, w, amp):
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    body = np.hypot(yy - h / 2, (xx - w / 2) * h / w) < 0.42 * h
    clean = np.where(body, 1.0, 0.05).astype(np.float32)
    clean[np.hypot(yy - h / 2, xx - 0.6 * w) < 0.15 * h] = 1.5
    bias = np.exp(amp * (xx / w - 0.5)).astype(np.float32)
    noise = rng.normal(0, 0.01, (h, w)).astype(np.float32)
    return clean * bias + noise, body


@pytest.mark.parametrize("h,w", [(32, 32), (48, 40)])
def test_n4_matches_jax(rng, h, w):
    """Two slices at once, each against JAX alone. Level 0 is the 1x1
    control grid (gaussian_blur pads it by 3), level 1 the 2x2."""
    pairs = [_biased(rng, h, w, amp) for amp in (0.3, 0.7)]
    imgs = np.stack([p[0] for p in pairs])
    masks = np.stack([p[1] for p in pairs]).astype(np.uint8)
    got, iters = rs.n4_bias_correction(torch.from_numpy(imgs),
                                       torch.from_numpy(masks),
                                       return_iterations=True)
    assert iters.shape == (2, 4) and iters.dtype == torch.int32
    assert bool((iters >= 1).all()) and bool(
        (iters <= torch.tensor(rs._N4_ITERS)).all())
    for s in range(2):
        want = np.asarray(jr.n4_bias_correction(jnp.asarray(imgs[s]),
                                                jnp.asarray(masks[s])))
        span = float(imgs[s].max() - imgs[s].min())
        np.testing.assert_allclose(got[s].numpy(), want, rtol=0,
                                   atol=N4_TOL * span)


def test_n4_without_a_mask_and_with_an_empty_one(rng):
    """No mask: an Otsu mask of the normalized slice (128 bins); an empty
    mask: the whole slice (JAX's fallback)."""
    img, _ = _biased(rng, 32, 32, 0.5)
    span = float(img.max() - img.min())
    got = rs.n4_bias_correction(torch.from_numpy(img[None]))[0].numpy()
    want = np.asarray(jr.n4_bias_correction(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=N4_TOL * span)
    empty = np.zeros((1, 32, 32), np.uint8)
    got = rs.n4_bias_correction(torch.from_numpy(img[None]),
                                torch.from_numpy(empty))[0].numpy()
    want = np.asarray(jr.n4_bias_correction(jnp.asarray(img),
                                            jnp.asarray(empty[0])))
    np.testing.assert_allclose(got, want, rtol=0, atol=N4_TOL * span)
