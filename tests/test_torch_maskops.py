"""Parity of the PyTorch port's mask ops and preprocessing chain with the
JAX package.

Masks are held bit-equal: the same seeded numpy inputs, the frozen goldens
(tests/goldens/*.npz) and the six real fastMRI panels go through the JAX
function and its port. The open/close plain version is also held against
the Pallas kernel run as tests/test_pallas_kernels.py runs it (interpret
mode on the CPU).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.data.preprocess import (
    MRIKneePreprocessor as JaxPreprocessor)
from mri_acl_imagesegmentation_adsp_tpu.ops import maskops as jm
from mri_acl_imagesegmentation_adsp_tpu.ops.pallas import fused_open_close
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import maskops
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import morphology
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_knee, synthetic_kspace_pairs)

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(scope="module")
def jax_body_mask():
    """The JAX body mask with exact connected components, jitted once."""
    return jax.jit(lambda x: jm.body_mask(x, cc_sweeps=None))


def _port_mask(imgs):
    return maskops.body_mask(torch.from_numpy(np.stack(imgs))).numpy()


def _port_otsu(imgs):
    flat = torch.from_numpy(np.stack(imgs)).flatten(1)
    return maskops.otsu_threshold_sorted(torch.sort(flat, dim=1).values
                                         ).numpy()


def test_otsu_and_body_mask_on_adversarial_goldens(jax_body_mask):
    z = np.load(GOLDENS / "otsu_adversarial.npz")
    names = sorted(k[len("otsu_"):] for k in z.files if k.startswith("otsu_"))
    imgs = [z[f"img_{n}"] for n in names]
    ths = _port_otsu(imgs)
    masks = _port_mask(imgs)
    for n, img, th, mask in zip(names, imgs, ths, masks):
        assert abs(float(th) - float(z[f"otsu_{n}"])) < 1e-6, n
        assert float(th) == float(jm.otsu_threshold(jnp.asarray(img))), n
        np.testing.assert_array_equal(mask, z[f"mask_{n}"], err_msg=n)
        np.testing.assert_array_equal(
            mask, np.asarray(jax_body_mask(jnp.asarray(img))), err_msg=n)


def test_body_mask_on_preprocess_goldens_and_synthetic(jax_body_mask, rng):
    z = np.load(GOLDENS / "preprocess_goldens.npz")
    imgs = [z[f"img_{i}"] for i in range(8)]
    imgs += [synthetic_knee(rng) for _ in range(4)]
    masks = _port_mask(imgs)
    for i, (img, mask) in enumerate(zip(imgs, masks)):
        np.testing.assert_array_equal(
            mask, np.asarray(jax_body_mask(jnp.asarray(img))), err_msg=str(i))
        if i < 8:
            np.testing.assert_array_equal(mask, z[f"mask_{i}"])
            v = (img - img.min()) / (img.max() - img.min())
            th = float(_port_otsu([v])[0])
            assert abs(th - float(z[f"otsu_{i}"])) < 1e-6


def test_body_mask_on_real_fastmri_panels(jax_body_mask):
    inputs = np.load(GOLDENS / "fastmri_real_panels.npz")["inputs"]
    imgs = list(inputs.astype(np.float32) / 255.0)
    masks = _port_mask(imgs)
    for i, (img, mask) in enumerate(zip(imgs, masks)):
        np.testing.assert_array_equal(
            mask, np.asarray(jax_body_mask(jnp.asarray(img))), err_msg=str(i))


def test_body_mask_constant_slice_is_empty():
    imgs = np.stack([np.full((40, 30), 3.0, np.float32),
                     synthetic_knee(np.random.default_rng(5), 40, 30)])
    masks = maskops.body_mask(torch.from_numpy(imgs)).numpy()
    assert masks.dtype == np.uint8 and not masks[0].any()


# The kernel's word edges (W mod 32) at small H, at three mask densities.
# The Pallas kernel (interpret mode) runs at the two first shapes and one
# edge shape; the conv formulation at all.
OPEN_CLOSE_CASES = [((64, 64), 0.45), ((96, 80), 0.45)] + [
    ((h, w), d) for h, w in [(40, 1), (33, 31), (17, 32), (40, 33), (25, 65)]
    for d in (0.05, 0.5, 0.95)]
PALLAS_SHAPES = {(64, 64), (96, 80), (33, 31)}


@pytest.mark.parametrize("shape,density", OPEN_CLOSE_CASES)
def test_open_close_plain_matches_jax_and_pallas(rng, shape, density):
    m = rng.random((3,) + shape) > 1 - density
    got = morphology.open_close(torch.from_numpy(m.astype(np.uint8)))
    se = jm.disk(2)
    for s in range(3):
        conv = np.asarray(jm.binary_closing(
            jm.binary_opening(jnp.asarray(m[s]), se), se))
        np.testing.assert_array_equal(got[s].numpy().astype(bool), conv)
        if shape in PALLAS_SHAPES:
            pallas = np.asarray(fused_open_close(jnp.asarray(m[s])))
            np.testing.assert_array_equal(got[s].numpy().astype(bool),
                                          pallas)


@pytest.mark.parametrize("band_rows", morphology.BAND_ROWS)
@pytest.mark.parametrize("offset", [-1, 0, 1, 9])
def test_band_plan_covers_each_row_once(band_rows, offset):
    """The kernel's grid: band b of a slice writes rows [b * R,
    min((b + 1) * R, H)). At the heights the card tests use, the bands of
    the wrapper's choice cover [0, H) exactly once, and so do those of a
    forced band height."""
    for s, h in [(1, band_rows + offset), (3, band_rows + offset), (1, 1),
                 (2, 2), (8, 640), (35, 640)]:
        for rows, n_bands in [morphology.band_plan(s, h),
                              (band_rows, -(-h // band_rows))]:
            covered = np.zeros(h, int)
            for b in range(n_bands):
                covered[b * rows:min((b + 1) * rows, h)] += 1
            assert (covered == 1).all(), (s, h, rows, n_bands)


def test_band_plan_fills_the_card():
    """At a served request's (8, 640, 368) and a volume's (35, 640, 368)
    the grid has at least one block per SM of an H100 (132)."""
    for s in (8, 35):
        rows, n_bands = morphology.band_plan(s, 640)
        assert s * n_bands >= morphology.SMS
        assert rows in morphology.BAND_ROWS
    assert morphology.band_plan(35, 640)[0] == 64
    assert morphology.band_plan(8, 640)[0] == 32
    with pytest.raises(ValueError):
        morphology._open_close(torch.zeros(1, 8, 8, dtype=torch.uint8), 0)


@pytest.mark.parametrize("case", ["ones", "zeros", "single_pixel"])
def test_open_close_border_cases(case):
    m = np.zeros((32, 32), bool)
    if case == "ones":
        m[:] = True
    elif case == "single_pixel":
        m[16, 16] = True
    got = morphology.open_close(torch.from_numpy(m[None].astype(np.uint8)))
    want = np.asarray(fused_open_close(jnp.asarray(m)))
    np.testing.assert_array_equal(got[0].numpy().astype(bool), want)
    assert bool(got.all()) if case == "ones" else not bool(got.any())


def test_remove_small_objects_matches_jax(rng):
    m = np.zeros((2, 64, 64), bool)
    m[0, 2:20, 2:20] = True                     # 324 px: kept
    m[0, 30:45, 30:45] = True                   # 225 px: removed
    m[0, 50:58, 2:34] = True                    # exactly 256 px: kept
    m[1] = rng.random((64, 64)) > 0.4           # many ragged components
    got = maskops.remove_small_objects(torch.from_numpy(m), 256).numpy()
    rso = jax.jit(lambda x: jm.remove_small_objects(x, 256))
    for s in range(2):
        np.testing.assert_array_equal(got[s],
                                      np.asarray(rso(jnp.asarray(m[s]))))


def test_label_components_exact_on_a_serpentine():
    """A corridor whose minimum label needs many row/column turns: the
    port iterates to the fixpoint and finds one component, like the JAX
    exact path."""
    h = w = 65
    m = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        m[r, :] = True
    for i, r in enumerate(range(0, h - 2, 2)):
        m[r + 1, w - 1 if i % 2 == 0 else 0] = True
    lbl = maskops.label_components(torch.from_numpy(m[None]))[0].numpy()
    want = np.asarray(jax.jit(jm.label_components)(jnp.asarray(m)))
    np.testing.assert_array_equal(lbl, want)
    assert len(np.unique(lbl[m])) == 1


def test_preprocess_volume_pairs_matches_jax():
    """Seeded (6, 64, 48, 2) k-space volume through both chains. Masks
    bit-equal; the z-scored tensor and preview to rtol = atol = 2e-5 (the
    iFFT's ~1e-6 relative difference, amplified by the z-score's 1/std;
    3.5e-6 measured)."""
    pair = synthetic_kspace_pairs(seed=11, s=6, h=64, w=48)
    kw = dict(out_size=(32, 32), slice_keep=(0.0, 1.0))
    want = JaxPreprocessor(**kw).preprocess_volume_pairs(pair)
    got = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(pair)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert got["mask"].numpy().any()
    np.testing.assert_allclose(got["tensor"].numpy(), want["tensor"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["preview"].numpy(), want["preview"],
                               rtol=2e-5, atol=2e-5)
    assert got["indices"] == list(want["indices"])
    band = MRIKneePreprocessor(device="cpu", out_size=(32, 32))
    assert band.preprocess_volume_pairs(pair)["indices"] == [1, 2, 3]


def test_preprocess_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        MRIKneePreprocessor(use_n4=True, device="cpu")
    with pytest.raises(ValueError):
        MRIKneePreprocessor(slice_keep=(0.7, 0.3), device="cpu")
    with pytest.raises(ValueError):
        MRIKneePreprocessor(device="cpu").preprocess_volume_pairs(
            np.zeros((2, 3, 8, 8, 2), np.float32))
