"""Parity of the PyTorch port's mask ops and preprocessing chain with the
JAX package.

Masks are held bit-equal: the same seeded numpy inputs, the frozen goldens
(tests/goldens/*.npz) and the six real fastMRI panels go through the JAX
function and its port. The open/close plain version is also held against
the Pallas kernel run as tests/test_pallas_kernels.py runs it (interpret
mode on the CPU); the plain connected components against the JAX exact
path at the label kernel's edge cases, bit-equal; the plain masked max
propagation against the probe's ``prop_xla`` loop
(``scripts/probe_pallas_roll.py:59-65``), rebuilt here with ``jnp.roll``
since the script imports the TPU Pallas module when it loads.
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
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
    components, morphology)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    component_masks, synthetic_knee, synthetic_kspace_pairs)

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
    """N4, NL-means and multi-coil k-space are ported now; what is refused
    is a bad band, a bad k-space shape and volumes spread over cards."""
    pre = MRIKneePreprocessor(use_n4=True, use_denoise=True, device="cpu")
    assert pre.use_n4 and pre.use_denoise
    with pytest.raises(ValueError):
        MRIKneePreprocessor(slice_keep=(0.7, 0.3), device="cpu")
    with pytest.raises(ValueError):
        MRIKneePreprocessor(device="cpu").preprocess_volume_pairs(
            np.zeros((2, 3, 8, 8, 3), np.float32))
    with pytest.raises(NotImplementedError):
        MRIKneePreprocessor(device="cpu").preprocess_volumes_pairs(
            [np.zeros((2, 8, 8, 2), np.float32)], devices=["cpu", "cpu"])


# The label kernel's edge cases at CPU sizes: widths across the 32-pixel
# tiles, H = 1 and 20, all foreground / background, a checkerboard, a
# 129x65 serpentine (64 sweeps), one-pixel rings, components on every
# border. chip_smoke.py and tests/test_torch_cuda.py take the full list.
SMALL_CC = component_masks(np.random.default_rng(3),
                           widths=(1, 31, 32, 33, 65), heights=(1, 20),
                           maze_hw=(129, 65))


@pytest.fixture(scope="module")
def jax_label():
    return jax.jit(jm.label_components)


@pytest.mark.parametrize("name", [n for n, _ in SMALL_CC])
def test_label_components_plain_matches_jax_at_kernel_edges(jax_label,
                                                            name):
    m = dict(SMALL_CC)[name]
    got = maskops.label_components(torch.from_numpy(m))
    assert got.dtype == torch.int32
    for s in range(m.shape[0]):
        want = np.asarray(jax_label(jnp.asarray(m[s])))
        assert want.dtype == np.int32
        np.testing.assert_array_equal(got[s].numpy(), want, err_msg=name)
    if name == "checkerboard":
        fg = m[0]
        assert (got[0].numpy()[fg] == np.flatnonzero(fg.ravel())).all()
    if name == "all_background":
        assert (got.numpy() == m.shape[1] * m.shape[2]).all()


def _prop_xla(mask, x, iters):
    """The probe's ``prop_xla`` with its ITERS as an argument."""
    def body(i, v):
        nb = jnp.maximum(jnp.maximum(jnp.roll(v, 1, 0), jnp.roll(v, -1, 0)),
                         jnp.maximum(jnp.roll(v, 1, 1), jnp.roll(v, -1, 1)))
        return jnp.where(mask > 0, jnp.maximum(v, nb), v)
    return jax.lax.fori_loop(0, iters, body, x)


@pytest.mark.parametrize("shape,iters", [((320, 320), 128), ((33, 47), 17),
                                         ((1, 1), 2), ((5, 1), 4)])
def test_masked_max_prop_plain_matches_the_probe(shape, iters):
    """The probe's input (mask density 0.6, x = (index + 1) * mask) at its
    (320, 320) and 128 iterations, and odd shapes; max and select are
    exact, so bit-equal. On the CPU the wrapper is the plain version."""
    rng = np.random.default_rng(0)
    mask = (rng.random(shape) > 0.4).astype(np.float32)
    x = (np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
         ) * mask
    want = np.asarray(jax.jit(_prop_xla, static_argnums=2)(
        jnp.asarray(mask), jnp.asarray(x), iters))
    mt, xt = torch.from_numpy(mask), torch.from_numpy(x)
    got = components.masked_max_prop_reference(mt, xt, iters)
    np.testing.assert_array_equal(got.numpy(), want)
    before = dict(components.LAUNCHES)
    np.testing.assert_array_equal(
        components.masked_max_prop(mt, xt, iters).numpy(), want)
    assert components.LAUNCHES == before


def test_component_wrappers_check_their_input():
    with pytest.raises(ValueError):
        components.label_components(torch.zeros(4, 4, dtype=torch.uint8))
    with pytest.raises(TypeError):
        components.masked_max_prop(torch.zeros(4, 4, dtype=torch.float64),
                                   torch.zeros(4, 4), 1)
    with pytest.raises(ValueError):
        components.masked_max_prop(torch.zeros(4, 4), torch.zeros(4, 5), 1)
    with pytest.raises(ValueError):
        components.masked_max_prop(torch.zeros(4, 4), torch.zeros(4, 4), -1)


def test_body_mask_is_remove_small_objects_of_the_open_closed_mask(rng):
    imgs = torch.from_numpy(np.stack([synthetic_knee(rng, 64, 48)
                                      for _ in range(3)]))
    pre, nonzero = maskops.open_closed_otsu_mask(imgs)
    assert pre.dtype == torch.uint8 and bool(nonzero.all())
    want = maskops.remove_small_objects(pre, 256).to(torch.uint8)
    assert torch.equal(maskops.body_mask(imgs), want)
