"""Parity of the PyTorch port's exact EDT and surface metrics with the JAX
package (``ops/edt.py``), on seeded numpy masks.

Tolerances:
- ``edt``: exactly equal, unit and anisotropic spacing alike, and a batch
  of slices equal to the slices one by one;
- ``hd95`` / ``assd``: within 1e-6 relative (ASSD's sum is float64 in the
  port, float32 in JAX), empty-mask cases exactly equal;
- against the scipy oracle of the reference's medimetrics code
  (``tests/test_edt.py``): 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_edt import _ref_assd, _ref_hd95

from mri_acl_imagesegmentation_adsp_tpu.metrics import medimetrics as jmm
from mri_acl_imagesegmentation_adsp_tpu.ops.edt import (
    _edt_sampled as jax_edt_sampled, assd as jax_assd, edt as jax_edt,
    hd95 as jax_hd95)
from mri_acl_imagesegmentation_adsp_tpu_torch.metrics import medimetrics
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import edt

SPACINGS = [(1.0, 1.0), (0.7, 1.3), (2.0, 0.5)]


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _masks():
    """Named (H, W) masks: random densities, a non-square shape, blobs, one
    pixel, all zeros and all ones (no zero: the sentinel)."""
    rng = np.random.default_rng(11)
    one = np.zeros((40, 33), bool)
    one[17, 5] = True
    corner = np.zeros((40, 33), bool)
    corner[0, 32] = True
    return {
        "p0.3": rng.random((48, 56)) > 0.3,
        "p0.9": rng.random((48, 56)) > 0.9,
        "p0.995": rng.random((64, 64)) > 0.995,
        "blob": _blob(64, 64, 30, 33, 14),
        "one_pixel": one,
        "corner_pixel": corner,
        "zeros": np.zeros((16, 24), bool),
        "ones": np.ones((16, 24), bool),
    }


def _jax_edt(m, spacing):
    if spacing == (1.0, 1.0):
        return np.asarray(jax_edt(jnp.asarray(m)))
    return np.asarray(jax_edt_sampled(jnp.asarray(m), *spacing))


@pytest.mark.parametrize("spacing", SPACINGS, ids=str)
@pytest.mark.parametrize("name", list(_masks()))
def test_edt_bit_equal_to_jax(name, spacing):
    m = _masks()[name]
    got = edt.edt(torch.from_numpy(m), spacing).numpy()
    want = _jax_edt(m, spacing)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if name == "ones":       # no zero: the sentinel (H + W) * row spacing
        np.testing.assert_array_equal(
            got, np.float32((16 + 24) * np.float32(spacing[0])))


def test_edt_batch_equals_slices():
    rng = np.random.default_rng(3)
    stack = rng.random((5, 32, 40)) > np.array([0.2, 0.5, 0.9, 0.99, 1.0]
                                               )[:, None, None]
    got = edt.edt(torch.from_numpy(stack)).numpy()
    for i in range(5):
        np.testing.assert_array_equal(got[i], _jax_edt(stack[i], (1.0, 1.0)))


def _pairs():
    """(pred, gt) pairs: shifted blobs, random masks, and the empty cases."""
    rng = np.random.default_rng(5)
    a = _blob(64, 64, 32, 32, 14)
    empty = np.zeros((64, 64), bool)
    return {
        "shift3": (a, _blob(64, 64, 35, 29, 14)),
        "shift_radius": (a, _blob(64, 64, 30, 36, 10)),
        "random": (rng.random((48, 56)) > 0.7, rng.random((48, 56)) > 0.6),
        "sparse": (rng.random((64, 64)) > 0.99, a),
        "same": (a, a),
        "empty_pred": (empty, a),
        "empty_gt": (a, empty),
        "both_empty": (empty, empty),
    }


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("spacing", SPACINGS[:2], ids=str)
@pytest.mark.parametrize("name", list(_pairs()))
def test_hd95_assd_match_jax(name, spacing):
    p, g = _pairs()[name]
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    h, a = (float(v) for v in edt.hd95_assd(tp, tg, spacing))
    wh = float(jax_hd95(jnp.asarray(p), jnp.asarray(g), spacing))
    wa = float(jax_assd(jnp.asarray(p), jnp.asarray(g), spacing))
    assert float(edt.hd95(tp, tg, spacing)) == h
    assert float(edt.assd(tp, tg, spacing)) == a
    if name.endswith("empty") or name == "same":
        assert (h, a) == (wh, wa)
    assert _rel(h, wh) <= 1e-6, (h, wh)
    assert _rel(a, wa) <= 1e-6, (a, wa)
    if name == "both_empty":
        assert h == a == 0.0
    if name == "empty_pred":        # no zero in ~pred: the sentinel
        assert h == np.float32(64 + 64) * np.float32(spacing[0])
    # the float-returning report API over the same functions
    sp = None if spacing == (1.0, 1.0) else spacing
    assert medimetrics.hd95(p, g, sp) == pytest.approx(
        jmm.hd95(p, g, sp), rel=1e-6, abs=0)
    assert medimetrics.assd(p, g, sp) == pytest.approx(
        jmm.assd(p, g, sp), rel=1e-6, abs=0)


@pytest.mark.parametrize("name", ["shift3", "shift_radius", "random",
                                  "sparse"])
def test_hd95_assd_match_scipy_oracle(name):
    p, g = _pairs()[name]
    h, a = (float(v) for v in edt.hd95_assd(torch.from_numpy(p),
                                            torch.from_numpy(g)))
    assert abs(h - _ref_hd95(p, g)) <= 1e-5 * max(1.0, _ref_hd95(p, g))
    assert abs(a - _ref_assd(p, g)) <= 1e-5 * max(1.0, _ref_assd(p, g))


def test_batched_metrics_equal_slices():
    pairs = [v for k, v in _pairs().items() if v[0].shape == (64, 64)]
    p = torch.from_numpy(np.stack([x for x, _ in pairs]))
    g = torch.from_numpy(np.stack([y for _, y in pairs]))
    h, a = edt.hd95_assd(p, g)
    assert h.shape == a.shape == (len(pairs),)
    for i in range(len(pairs)):
        hi, ai = edt.hd95_assd(p[i], g[i])
        assert float(h[i]) == float(hi) and float(a[i]) == float(ai)


def test_dice_iou_report_api_matches_jax():
    for p, g in _pairs().values():
        assert medimetrics.dice_bin(p, g) == pytest.approx(
            jmm.dice_bin(p, g), rel=1e-6)
        assert medimetrics.iou_bin(p, g) == pytest.approx(
            jmm.iou_bin(p, g), rel=1e-6)
