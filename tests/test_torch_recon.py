"""Classical reconstruction of the port against the JAX package's, on the
same seeded numpy inputs: the complex boundary (``ops/cpair.py``), the
Cartesian helpers, GRAPPA (geometry, Gram matrices, weights, hole-fill),
the T2 and DWI pipelines, the ISMRMRD header queries and ``cli.recon``.

Tolerances, each stated where it is used:
- geometry, grid matrix, header queries, host metrics: exact;
- iFFT / RSS, Gram matrices: 1e-5 of the reference's largest magnitude;
- GRAPPA's filled k-space: the numpy oracle at rtol 2e-3, atol 2e-4 (its
  own weights, which differ from JAX's within the systems' conditioning);
  JAX's filled k-space within 1e-5 of its largest magnitude when JAX's
  weights are carried across;
- T2 images: 1e-4 of the image maximum; DWI maps: 1e-4 of each map's
  maximum, counting the pixels past it (ADC and b1500 are thresholded).
"""
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.cli import recon as jcli
from mri_acl_imagesegmentation_adsp_tpu.data import recon_data as jrd
from mri_acl_imagesegmentation_adsp_tpu.ops import cpair as jcpair
from mri_acl_imagesegmentation_adsp_tpu.recon import cartesian as jcart
from mri_acl_imagesegmentation_adsp_tpu.recon import dwi as jdwi
from mri_acl_imagesegmentation_adsp_tpu.recon import t2 as jt2
from mri_acl_imagesegmentation_adsp_tpu.recon.grappa import Grappa as JGrappa
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import recon as cli
from mri_acl_imagesegmentation_adsp_tpu_torch.data import recon_data
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import cpair
from mri_acl_imagesegmentation_adsp_tpu_torch.recon import (
    cartesian, dwi, t2)
from mri_acl_imagesegmentation_adsp_tpu_torch.recon.grappa import Grappa

sys.path.insert(0, str(Path(__file__).parent))
from test_recon import _multicoil_phantom, oracle_grappa  # noqa: E402

REL = 1e-5          # iFFT / RSS, Gram matrices, shared-weight fill
T2_REL = 1e-4       # T2 image, relative to its maximum
DWI_REL = 1e-4      # each DWI map, relative to its maximum
EPI = {"rampUpTime": 100.0, "rampDownTime": 100.0, "flatTopTime": 400.0,
       "acqDelayTime": 10.0, "echoSpacing": 1.0}
ISMRMRD_HDR = """<?xml version="1.0"?>
<ismrmrdHeader xmlns="http://www.ismrm.org/ISMRMRD">
  <encoding>
    <encodedSpace><matrixSize><x>48</x><y>40</y><z>1</z></matrixSize></encodedSpace>
    <reconSpace><matrixSize><x>48</x><y>48</y><z>1</z></matrixSize></reconSpace>
    <encodingLimits><kspace_encoding_step_1>
      <minimum>0</minimum><maximum>39</maximum><center>20</center>
    </kspace_encoding_step_1></encodingLimits>
    <trajectoryDescription>
      <userParameterLong><name>rampUpTime</name><value>100</value></userParameterLong>
      <userParameterLong><name>rampDownTime</name><value>100</value></userParameterLong>
      <userParameterLong><name>flatTopTime</name><value>400</value></userParameterLong>
      <userParameterLong><name>acqDelayTime</name><value>10</value></userParameterLong>
      <userParameterLong><name>echoSpacing</name><value>1</value></userParameterLong>
    </trajectoryDescription>
  </encoding>
</ismrmrdHeader>"""


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# ---------------------------------------------------------------------------
# ops/cpair.py
# ---------------------------------------------------------------------------

def test_cpair_against_numpy(rng):
    x = _cplx(rng, (3, 4, 5))
    pair = cpair.to_pair_device(x, device="cpu")
    assert pair.dtype == torch.float32 and pair.shape == (3, 4, 5, 2)
    np.testing.assert_array_equal(pair.numpy(), np.stack([x.real, x.imag],
                                                         -1))
    np.testing.assert_array_equal(cpair.to_complex(pair), x)
    np.testing.assert_array_equal(cpair.to_complex(pair.numpy()), x)
    np.testing.assert_array_equal(
        cpair.to_complex(torch.view_as_complex(pair)), x)
    # a transposed (non-contiguous) and a complex128 array, and a real one
    np.testing.assert_array_equal(
        cpair.to_complex(cpair.to_pair_device(x.T, device="cpu")), x.T)
    np.testing.assert_array_equal(cpair.to_complex(cpair.to_pair_device(
        x.astype(np.complex128), device="cpu")), x)
    re = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        cpair.to_pair_device(re, device="cpu").numpy(),
        np.stack([re, np.zeros_like(re)], -1))
    with pytest.raises(ValueError, match="transfer_dtype"):
        cpair.to_pair_device(x, "float16", device="cpu")
    a = _cplx(rng, (6, 5, 5)) + 5 * np.eye(5, dtype=np.complex64)
    b = _cplx(rng, (6, 5, 2))
    got = cpair.csolve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["complex64", "transposed", "real"])
def test_bf16_transfer_pair_bit_equal_to_jax(rng, kind):
    """The bf16 link path rounds to nearest even on the host and upcasts:
    the pair that lands is JAX's bit for bit."""
    x = {"complex64": _cplx(rng, (2, 5, 7)),
         "transposed": _cplx(rng, (2, 5, 7)).T,
         "real": rng.standard_normal((2, 5, 7)).astype(np.float32)}[kind]
    x = x * 1.2345
    got = cpair.to_pair_device(x, "bfloat16", device="cpu").numpy()
    want = np.asarray(jcpair.to_pair_device(x, "bfloat16"))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.asarray(jcpair.to_pair_device(x)))


# ---------------------------------------------------------------------------
# recon/cartesian.py
# ---------------------------------------------------------------------------

def test_cartesian_helpers_match_jax(rng):
    k = _cplx(rng, (2, 3, 12, 10))
    pair = np.stack([k.real, k.imag], -1)
    want = np.asarray(jcart.ifftnd_scaled(jcpair.to_pair(k), [-2, -1]))
    got_pair = cartesian.ifftnd_scaled(torch.from_numpy(pair), [-2, -1])
    got_c = cartesian.ifftnd_scaled(torch.from_numpy(k), [2, 3])
    assert _rel(got_pair.numpy(), want) <= REL
    assert _rel(torch.view_as_real(got_c).numpy(), want) <= REL
    for x, axes in ((torch.from_numpy(pair), [-3, -1]),
                    (torch.from_numpy(k), [0, 1])):
        with pytest.raises(NotImplementedError):
            cartesian.ifftnd_scaled(x, axes)
    assert _rel(cartesian.recon_multicoil_rss(k, coil_axis=1, device="cpu"),
                jcart.recon_multicoil_rss(k, coil_axis=1)) <= REL
    assert _rel(cartesian.recon_multicoil_rss(pair, coil_axis=0,
                                              device="cpu"),
                jcart.recon_multicoil_rss(pair, coil_axis=0)) <= REL
    assert _rel(cartesian.recon_singlecoil(k[0, 0], device="cpu"),
                jcart.recon_singlecoil(k[0, 0])) <= REL
    vol = rng.standard_normal((3, 50, 47))
    np.testing.assert_array_equal(cartesian.center_crop_im(vol, (32, 31)),
                                  jcart.center_crop_im(vol, (32, 31)))
    np.testing.assert_array_equal(cartesian.flip_im(vol, 1),
                                  jcart.flip_im(vol, 1))
    np.testing.assert_array_equal(
        cartesian.center_crop_im(torch.from_numpy(vol), (32, 31)).numpy(),
        jcart.center_crop_im(vol, (32, 31)))


# ---------------------------------------------------------------------------
# recon/grappa.py
# ---------------------------------------------------------------------------

def _undersampled(rng, pattern):
    _, ksp = _multicoil_phantom(rng)                   # (48, 40, 4)
    under = ksp.copy()
    if pattern == "r2":
        under[1::2] = 0
    elif pattern == "r3_acs":
        keep = np.zeros(48, bool)
        keep[::3] = True
        keep[20:28] = True
        under[~keep] = 0
    return ksp, under


@pytest.mark.parametrize("pattern", ["r2", "r3_acs", "full"])
def test_grappa_geometry_equals_jax(rng, pattern):
    _, under = _undersampled(rng, pattern)
    got = Grappa(under, (5, 5), -1, device="cpu").kernel_var_dict
    want = JGrappa(under, (5, 5), -1).kernel_var_dict
    assert got.keys() == want.keys()
    for key in ("patches", "patch_indices", "iidx_map"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("holes_x", "holes_y"):
        assert got[key].keys() == want[key].keys()
        for g in want[key]:
            np.testing.assert_array_equal(got[key][g], want[key][g])
    assert (len(want["patch_indices"]) == 0) == (pattern == "full")


def test_compute_grams_matches_jax(rng):
    calibs = _cplx(rng, (2, 4, 16, 30))      # (S, coils, X, Y), coil_axis 0
    got = Grappa(calibs[0], (5, 5), 0, device="cpu").compute_grams(calibs)
    want = JGrappa(calibs[0], (5, 5), 0).compute_grams(calibs)
    assert got.shape == want.shape == (2, 100, 100)
    assert got.dtype == np.complex64
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("pattern", ["r2", "r3_acs"])
def test_grappa_fill_meets_the_numpy_oracle(rng, pattern):
    """The port with its own weights against the numpy oracle run in
    complex128, beside JAX's distance to it (printed)."""
    ksp, under = _undersampled(rng, pattern)
    calib = ksp[16:32]
    g = Grappa(under, (5, 5), -1, device="cpu")
    filled = g.apply_weights(under, g.compute_weights(calib))
    want = oracle_grappa(under.astype(np.complex128),
                         calib.astype(np.complex128))
    np.testing.assert_allclose(filled, want, rtol=2e-3, atol=2e-4)
    assert np.abs(filled[under[..., 0] == 0]).min() > 0
    jg = JGrappa(under, (5, 5), -1)
    jfilled = jg.apply_weights(under, jg.compute_weights(calib))
    print(f"GRAPPA {pattern}: max |fill - oracle| port "
          f"{np.abs(filled - want).max():.3e}, JAX "
          f"{np.abs(jfilled - want).max():.3e}, of max |oracle| "
          f"{np.abs(want).max():.3e}")


def test_grappa_fill_with_jax_weights_matches_jax(rng):
    """JAX's per-slice weight dicts carried into every apply entry point:
    the filled k-space agrees to f32 rounding."""
    ksp, under = _undersampled(rng, "r2")
    calibs = np.stack([ksp[16:32], 0.7 * ksp[12:28]])
    jg, tg = JGrappa(under, (5, 5), -1), Grappa(under, (5, 5), -1,
                                                device="cpu")
    weights = jg.compute_weights_batch(calibs)
    batch = np.stack([under, 1.3 * under, 0.5 * under])
    want = jg.apply_weights_batch(batch, weights[0])
    assert _rel(tg.apply_weights_batch(batch, weights[0]), want) <= REL
    assert _rel(tg.apply_weights(under, weights[1]),
                jg.apply_weights(under, weights[1])) <= REL
    multi = np.stack([batch, 2.0 * batch])                 # (S, B, X, Y, C)
    want = np.asarray(jg.apply_weights_pair_multi(
        jcpair.to_pair(multi), weights))
    got_pair = tg.apply_weights_pair_multi(
        torch.from_numpy(np.stack([multi.real, multi.imag], -1)), weights)
    got_c = tg.apply_weights_pair_multi(torch.from_numpy(multi),
                                        dict(enumerate(weights)))
    assert not got_pair.is_complex() and got_c.is_complex()
    assert _rel(got_pair.numpy(), want) <= REL
    assert _rel(torch.view_as_real(got_c).numpy(), want) <= REL
    # the port's own solve: the same geometries; its weights agree with
    # JAX's to within the systems' conditioning (printed), not bit for bit
    mine = tg.compute_weights_batch(calibs)
    assert [w.keys() for w in mine] == [w.keys() for w in weights]
    worst = max(_rel(m[g], w[g]) for m, w in zip(mine, weights) for g in w)
    print(f"GRAPPA weights, port vs JAX, max relative to each geometry's "
          f"max: {worst:.3e}")
    assert worst < 1e-2


def test_grappa_fully_sampled_is_a_no_op(rng):
    ksp, _ = _undersampled(rng, "full")
    g = Grappa(ksp, coil_axis=-1, device="cpu")
    assert len(g.kernel_var_dict["patch_indices"]) == 0
    assert g.compute_weights(ksp[16:32]) == {}
    np.testing.assert_allclose(g.apply_weights(ksp, {}), ksp, atol=1e-6)


def test_mesh_is_refused(rng):
    """A mesh of devices, once refused, now spreads the slices: the fill
    and both pipelines over two CPU devices equal one device
    (``tests/test_torch_recon_mesh.py`` holds them to JAX's mesh runs)."""
    ksp, under = _undersampled(rng, "r2")
    g = Grappa(under, coil_axis=-1, device="cpu")
    w = g.compute_weights(ksp[16:32])
    k = torch.from_numpy(np.stack([under, 0.5 * under])[:, None])
    torch.testing.assert_close(
        g.apply_weights_pair_multi(k, [w, w], mesh=["cpu", "cpu"]),
        g.apply_weights_pair_multi(k, [w, w]), rtol=0, atol=0)
    kspace, calib = _t2_case(rng, slices=3)
    np.testing.assert_array_equal(
        t2.t2_reconstruction(kspace, calib, mesh=["cpu", "cpu"],
                             device="cpu")["reconstruction_rss"],
        t2.t2_reconstruction(kspace, calib, device="cpu")[
            "reconstruction_rss"])
    ksp_d, cal_d, sens_d = _dwi_case(rng, slices=2)
    got = dwi.dwi_reconstruction(ksp_d, cal_d, sens_d, EPI,
                                 mesh=["cpu", "cpu"], device="cpu")
    want = dwi.dwi_reconstruction(ksp_d, cal_d, sens_d, EPI, device="cpu")
    assert _dwi_maps_agree(got, want) == dict.fromkeys(want, 0)


# ---------------------------------------------------------------------------
# recon/t2.py
# ---------------------------------------------------------------------------

def _t2_case(rng, slices=1):
    h, w, nc = 48, 40, 4
    _, ksp = _multicoil_phantom(rng, h, w, nc)
    full = np.moveaxis(ksp, -1, 0)                      # (C, ro, pe)
    under = full.copy()
    under[:, :, 1::2] = 0
    under[:, :, w // 2 - 6: w // 2 + 6] = full[:, :, w // 2 - 6: w // 2 + 6]
    scales = [1.0, 0.7, 1.3][:slices]
    kspace = np.stack([np.stack([s * under for s in scales])] * 3)
    calib = np.stack([s * full[:, :, w // 2 - 8: w // 2 + 8]
                      for s in scales])
    return kspace.astype(np.complex64), calib.astype(np.complex64)


@pytest.mark.parametrize("hdr", [None, 4.0, ISMRMRD_HDR,
                                 ISMRMRD_HDR.encode()])
def test_t2_reconstruction_matches_jax(rng, hdr):
    kspace, calib = _t2_case(rng, slices=2)
    want = jt2.t2_reconstruction(kspace, calib, hdr=hdr)["reconstruction_rss"]
    got = t2.t2_reconstruction(kspace, calib, hdr=hdr, device="cpu")
    assert set(got) == {"reconstruction_rss"}
    got = got["reconstruction_rss"]
    assert got.shape == want.shape == (2, 48, 40 if hdr is None else 48)
    assert got.dtype == np.float32
    assert _rel(got, want) <= T2_REL


def _t2_oracle(kspace, calib):
    """The T2 pipeline in complex128 numpy: ``oracle_grappa`` on each
    average (averages 0 and 2 share the first geometry, as the weights do
    not depend on the data), then the orthonormal iFFT, RSS, flipud and
    the mean over averages; no padding, no crop (the image is under 320)."""
    out = []
    for s in range(kspace.shape[1]):
        cal = np.transpose(calib[s], (2, 1, 0)).astype(
            np.complex128)                               # (pe, ro, C)
        mags = []
        for a in range(3):
            k = np.transpose(kspace[a, s], (2, 1, 0)).astype(np.complex128)
            f = np.transpose(oracle_grappa(k, cal), (2, 1, 0))  # (C, ro, pe)
            img = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(
                f, axes=(-2, -1)), norm="ortho"), axes=(-2, -1))
            mags.append(np.sqrt((np.abs(img) ** 2).sum(0))[::-1])
        out.append(np.mean(mags, axis=0))
    return np.stack(out)


def test_t2_reconstruction_against_a_float64_oracle(rng):
    """Both packages against the complex128 numpy pipeline (printed: which
    side is nearer), each within 1e-4 of the image maximum."""
    kspace, calib = _t2_case(rng)
    want = _t2_oracle(kspace, calib)
    got = t2.t2_reconstruction(kspace, calib, device="cpu")[
        "reconstruction_rss"]
    jgot = jt2.t2_reconstruction(kspace, calib)["reconstruction_rss"]
    port, jax_ = _rel(got, want), _rel(jgot, want)
    print(f"T2 vs the float64 oracle, relative to its max: port {port:.3e},"
          f" JAX {jax_:.3e}")
    assert port <= T2_REL and jax_ <= T2_REL


def test_t2_slice_chunks_and_bf16_transfer_match(rng):
    kspace, calib = _t2_case(rng, slices=3)
    whole = t2.t2_reconstruction(kspace, calib, device="cpu")
    one_slice = kspace.shape[2] * kspace.shape[3] * kspace.shape[4] * 16
    chunked = t2.t2_reconstruction(
        kspace, calib, device="cpu",
        max_stage_bytes=one_slice * t2.STAGE_COPIES)
    np.testing.assert_allclose(chunked["reconstruction_rss"],
                               whole["reconstruction_rss"], rtol=1e-6,
                               atol=1e-6 * whole["reconstruction_rss"].max())
    # bf16: both packages round the upload alike, so they agree as in f32
    got = t2.t2_reconstruction(kspace, calib, transfer_dtype="bfloat16",
                               device="cpu")["reconstruction_rss"]
    want = jt2.t2_reconstruction(kspace, calib, transfer_dtype="bfloat16")[
        "reconstruction_rss"]
    assert _rel(got, want) <= T2_REL
    assert _rel(got, whole["reconstruction_rss"]) < 2e-2
    with pytest.raises(ValueError, match="transfer_dtype"):
        t2.t2_reconstruction(kspace, calib, transfer_dtype="int8",
                             device="cpu")


def test_t2_helpers_match_jax(rng):
    assert t2.get_padding(ISMRMRD_HDR) == jt2.get_padding(ISMRMRD_HDR) == 4.0
    plain = "<x>50</x><kspace_encoding_step_1><maximum>40</maximum>"
    assert t2.get_padding(plain) == jt2.get_padding(plain) == 4.5
    with pytest.raises(ValueError):
        t2.get_padding("<nothing/>")
    for p in (0.0, 3.0, 4.0, 4.5):
        assert t2.pad_split(p) == jt2.pad_split(p)
    k = _cplx(rng, (2, 3, 6, 5))
    np.testing.assert_array_equal(t2.zero_pad_kspace(k, 3.0),
                                  jt2.zero_pad_kspace(k, 3.0))
    assert _rel(t2.create_coil_combined_im(k, device="cpu"),
                jt2.create_coil_combined_im(k)) <= REL


# ---------------------------------------------------------------------------
# recon/dwi.py and data/recon_data.py
# ---------------------------------------------------------------------------

def _dwi_case(rng, slices=2, pe=24):
    ksp = _cplx(rng, (51, slices, 2, 200, pe)) * 0.1
    mask = np.zeros(pe, bool)
    mask[::2] = True
    mask[pe // 2 - 4: pe // 2 + 4] = True
    ksp[..., ~mask] = 0
    return (ksp, _cplx(rng, (slices, 2, 200, pe)) * 0.1,
            _cplx(rng, (slices, 2, 200, pe)))


def _dwi_maps_agree(got, want) -> dict:
    """Pixels past ``DWI_REL`` of each map's maximum, by key."""
    assert set(got) == set(want)
    past = {}
    for key in want:
        assert got[key].shape == want[key].shape, key
        scale = np.abs(want[key]).max()
        past[key] = int((np.abs(got[key] - want[key])
                         > DWI_REL * scale).sum())
    return past


def test_dwi_reconstruction_matches_jax(rng):
    ksp, calib, sens = _dwi_case(rng)
    want = jdwi.dwi_reconstruction(ksp, calib, sens, EPI)
    got = dwi.dwi_reconstruction(ksp, calib, sens, EPI, device="cpu")
    past = _dwi_maps_agree(got, want)
    print("DWI pixels past 1e-4 of the map's max:", past)
    thresholded = ("adc_map", "b1500")
    assert all(n == 0 for k, n in past.items() if k not in thresholded), past
    size = want["b1500"].size
    assert all(past[k] <= 1e-3 * size for k in thresholded), past


def test_dwi_slice_chunks_match_a_single_flush(rng):
    ksp, calib, sens = _dwi_case(rng, slices=3)
    slice_bytes = 51 * 2 * 200 * 24 * 8
    whole = dwi.dwi_reconstruction(ksp, calib, sens, EPI, device="cpu",
                                   max_stage_bytes=1e12)
    chunked = dwi.dwi_reconstruction(
        ksp, calib, sens, EPI, device="cpu",
        max_stage_bytes=slice_bytes * dwi.STAGE_COPIES)
    assert _dwi_maps_agree(chunked, whole) == dict.fromkeys(whole, 0)
    lo = dwi.dwi_reconstruction(ksp, calib, sens, EPI, device="cpu",
                                transfer_dtype="bfloat16")
    for key in whole:
        assert _rel(lo[key], whole[key]) < 3e-2, key


def test_regridding_and_diffusion_metrics_match_jax(rng):
    np.testing.assert_array_equal(dwi.get_grid_mat(EPI),
                                  jdwi.get_grid_mat(EPI))
    flat = dict(EPI, rampUpTime=0.0)
    np.testing.assert_array_equal(dwi.get_grid_mat(flat, keep_oversampling=
                                                   False),
                                  jdwi.get_grid_mat(flat,
                                                    keep_oversampling=False))
    img = _cplx(rng, (4, 200, 10))
    assert _rel(dwi.trapezoidal_regridding(img, EPI, device="cpu"),
                jdwi.trapezoidal_regridding(img, EPI)) <= REL
    vol = np.abs(rng.standard_normal((50, 2, 8, 8))) + 0.5
    got, want = dwi.compute_averages(vol), jdwi.compute_averages(vol)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    for a, b in zip(dwi.trace(got), jdwi.trace(want)):
        np.testing.assert_array_equal(a, b)
    got, want = (dwi.compute_trace_adc_b1500(dict(got)),
                 jdwi.compute_trace_adc_b1500(dict(want)))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    raw = np.abs(rng.standard_normal((8, 8, 3, 2))) * 100 + 1
    for a, b in zip(dwi.adc(raw, -1e6, [50, 1000]),
                    jdwi.adc(raw, -1e6, [50, 1000])):
        np.testing.assert_array_equal(a, b)


def test_ismrmrd_queries_match_jax():
    import xml.etree.ElementTree as etree
    assert (recon_data.get_regridding_params(ISMRMRD_HDR)
            == jrd.get_regridding_params(ISMRMRD_HDR) == EPI)
    root = etree.fromstring(ISMRMRD_HDR)
    q = ["encoding", "encodedSpace", "matrixSize", "x"]
    assert recon_data.et_query(root, q) == jrd.et_query(root, q) == "48"
    with pytest.raises(RuntimeError, match="not found"):
        recon_data.et_query(root, ["encoding", "nothing"])


# ---------------------------------------------------------------------------
# cli/recon.py
# ---------------------------------------------------------------------------

def _write_cases(tmp_path, rng):
    """A tiny undersampled T2 case and a tiny DWI case."""
    kspace, calib = _t2_case(rng)
    t2_dir = tmp_path / "training" / "T2"
    t2_dir.mkdir(parents=True)
    with h5py.File(t2_dir / "case0.h5", "w") as hf:
        hf.create_dataset("kspace", data=kspace)
        hf.create_dataset("calibration_data", data=calib)
        hf.create_dataset("ismrmrd_header", data=ISMRMRD_HDR.encode())
        hf.create_dataset("reconstruction_rss",
                          data=np.zeros((1, 48, 48), np.float32))
        hf.attrs["max"] = 1.0
    (t2_dir / "notes.txt").write_text("not an h5")
    ksp, cal, sens = _dwi_case(rng, slices=1)
    dwi_dir = tmp_path / "training" / "DIFFUSION"
    dwi_dir.mkdir(parents=True)
    with h5py.File(dwi_dir / "dcase.h5", "w") as hf:
        hf.create_dataset("kspace", data=ksp)
        hf.create_dataset("calibration_data", data=cal)
        hf.create_dataset("coil_sens_maps", data=sens)
        hf.create_dataset("ismrmrd_header", data=ISMRMRD_HDR.encode())
    return t2_dir / "case0.h5", dwi_dir / "dcase.h5"


def test_cli_recon_matches_jax_reconstruct_case(tmp_path, rng):
    t2_case, dwi_case = _write_cases(tmp_path, rng)
    for sequence, case in (("t2", t2_case), ("dwi", dwi_case)):
        out = tmp_path / f"recons_{sequence}"
        assert cli.main(["--data-path", str(tmp_path), "--output-path",
                         str(out), "--sequence", sequence, "--device",
                         "cpu"]) == 0
        assert sorted(p.name for p in out.iterdir()) == [case.name]
        want = jcli.reconstruct_case(str(case), sequence)
        with h5py.File(out / case.name, "r") as hf:
            got = {k: hf[k][()] for k in hf}
        if sequence == "t2":
            assert set(got) == {"reconstruction_rss"}
            assert got["reconstruction_rss"].shape == (1, 48, 48)
            assert _rel(got["reconstruction_rss"],
                        want["reconstruction_rss"]) <= T2_REL
        else:
            past = _dwi_maps_agree(got, want)
            assert got["b1500"].shape == (1, 100, 24)
            assert sum(past.values()) <= 1e-3 * got["b1500"].size, past


def test_cli_recon_refuses_data_parallel_and_missing_dirs(tmp_path, capsys):
    """``--data-parallel 2`` is taken now (two CPU devices, then the
    missing directory stops the run); on cards it asks for two."""
    base = ["--data-path", str(tmp_path), "--output-path",
            str(tmp_path / "o"), "--sequence", "t2"]
    with pytest.raises(SystemExit):
        cli.main(base + ["--device", "cpu", "--data-parallel", "2"])
    assert "no such dir" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(base + ["--device", "cpu"])
    assert "no such dir" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 2 devices, have 0"):
            cli.main(base + ["--data-parallel", "2"])


def test_recon_and_ingest_entry_points_default_to_the_card(tmp_path, rng):
    """Without a card, every recon and ingest entry point left at its
    default device raises naming cuda; none runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    from types import SimpleNamespace
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.adapters import (
        KneePckAdapter)
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
        build_preprocess)
    kspace, calib = _t2_case(rng)
    ksp, cal, sens = _dwi_case(rng, slices=1)
    _write_cases(tmp_path, rng)
    for call in (
            lambda: Grappa(kspace[0, 0], coil_axis=0),
            lambda: t2.t2_reconstruction(kspace, calib),
            lambda: dwi.dwi_reconstruction(ksp, cal, sens, EPI),
            lambda: cartesian.recon_singlecoil(kspace[0, 0, 0]),
            lambda: cpair.to_pair_device(calib),
            lambda: cli.main(["--data-path", str(tmp_path), "--output-path",
                              str(tmp_path / "o"), "--sequence", "t2"]),
            lambda: build_preprocess(SimpleNamespace(
                root_dir=str(tmp_path), out_dir=str(tmp_path / "art"),
                height=32, width=32, slice_keep="0.3,0.7",
                clip="1.0,99.5", use_n4=False, use_denoise=False,
                preview_max=0), KneePckAdapter())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
