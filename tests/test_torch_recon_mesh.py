"""Slices and volumes spread over devices, no collective: the T2 and DWI
pipelines with their GRAPPA hole-fill over a mesh of devices, ``cli.recon
--data-parallel``, and ``preprocess_volumes_pairs(devices=)``, on the CPU
against the JAX package's mesh runs and the port's one-device runs.

The slice counts (T2: 5, DWI: 3) are uneven on the 2-device mesh: JAX pads
them with repeats of the last slice, the port gives the first device one
slice more. Tolerances, each stated where it is checked:
- T2 images and DWI maps against JAX's ``mesh=make_mesh(2)`` run: those of
  ``tests/test_torch_recon.py`` (1e-4 of the image's / each map's maximum,
  ADC and b1500 counting the pixels past it);
- against the port's one-device run, and ``cli.recon --data-parallel 2``
  against ``--data-parallel 1``: equal (the same per-slice arithmetic);
- ``preprocess_volumes_pairs`` over devices: bit-equal to per-volume calls
  (JAX's own test holds its device list so), and to JAX's volumes spread
  over devices within ``tests/test_torch_maskops.py``'s rule (masks
  bit-equal, tensors 2e-5).
"""
import h5py
import jax
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.data.preprocess import (
    MRIKneePreprocessor as JaxPreprocessor)
from mri_acl_imagesegmentation_adsp_tpu.parallel import make_mesh
from mri_acl_imagesegmentation_adsp_tpu.recon import dwi as jdwi
from mri_acl_imagesegmentation_adsp_tpu.recon import t2 as jt2
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import recon as cli
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.recon import dwi, t2
from mri_acl_imagesegmentation_adsp_tpu_torch.recon.grappa import (
    Grappa, slice_shares)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

T2_REL = 1e-4
DWI_REL = 1e-4
THRESHOLDED = ("adc_map", "b1500")
EPI = {"rampUpTime": 100.0, "rampDownTime": 100.0, "flatTopTime": 400.0,
       "acqDelayTime": 10.0, "echoSpacing": 1.0}
CPU2 = ["cpu", "cpu"]
HDR = ("<ismrmrdHeader><encoding><encodedSpace><matrixSize><x>32</x>"
       "</matrixSize></encodedSpace><encodingLimits><kspace_encoding_step_1>"
       "<maximum>23</maximum></kspace_encoding_step_1></encodingLimits>"
       "</encoding></ismrmrdHeader>")          # a phase-encode pad of 4


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t2_case(slices, seed=0, nc=4, h=32, w=24):
    """Seeded undersampled T2 k-space ``(3, S, C, ro, pe)`` (every other
    phase-encode line and a 12-line centre) and its calibration."""
    rng = np.random.default_rng(seed)
    full = _cplx(rng, (slices, nc, h, w))
    under = full.copy()
    under[..., 1::2] = 0
    under[..., w // 2 - 6:w // 2 + 6] = full[..., w // 2 - 6:w // 2 + 6]
    return np.stack([under] * 3), full[..., w // 2 - 8:w // 2 + 8].copy()


def _dwi_case(slices, seed=1, pe=16):
    rng = np.random.default_rng(seed)
    ksp = _cplx(rng, (51, slices, 2, 200, pe)) * 0.1
    mask = np.zeros(pe, bool)
    mask[::2] = True
    mask[pe // 2 - 4:pe // 2 + 4] = True
    ksp[..., ~mask] = 0
    return (ksp, _cplx(rng, (slices, 2, 200, pe)) * 0.1,
            _cplx(rng, (slices, 2, 200, pe)))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_slice_shares_split_as_array_split():
    for n in (1, 3, 5, 8):
        for parts in (1, 2, 3):
            got = [list(range(s.start, s.stop))
                   for s in slice_shares(n, parts)]
            assert got == [list(a) for a in np.array_split(range(n),
                                                           parts)]


def test_grappa_fill_over_a_mesh_equals_one_device():
    """``apply_weights_pair_multi(mesh=)`` on 3 slices over 2 devices,
    each slice with its own weights, equals the one-device fill."""
    kspace, calib = _t2_case(3)
    g = Grappa(np.transpose(kspace[0, 0], (2, 0, 1)), (5, 5), 1,
               device="cpu")
    weights = g.compute_weights_batch(np.transpose(calib, (0, 3, 1, 2)))
    k = torch.view_as_complex(torch.from_numpy(np.stack(
        [kspace.real, kspace.imag], -1).astype(np.float32))).permute(
        1, 0, 4, 2, 3)                              # (S, avg, pe, C, ro)
    want = g.apply_weights_pair_multi(k, weights)
    got = g.apply_weights_pair_multi(k, weights, mesh=CPU2)
    assert got.shape == want.shape == k.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_t2_on_a_mesh_matches_jax_and_one_device():
    kspace, calib = _t2_case(5)
    want = jt2.t2_reconstruction(kspace, calib, mesh=make_mesh(2))[
        "reconstruction_rss"]
    one = t2.t2_reconstruction(kspace, calib, device="cpu")[
        "reconstruction_rss"]
    got = t2.t2_reconstruction(kspace, calib, mesh=CPU2, device="cpu")[
        "reconstruction_rss"]
    assert got.shape == want.shape == (5, 32, 24)
    assert _rel(got, want) <= T2_REL
    np.testing.assert_array_equal(got, one)


def test_dwi_on_a_mesh_matches_jax_and_one_device():
    ksp, calib, sens = _dwi_case(3)
    want = jdwi.dwi_reconstruction(ksp, calib, sens, EPI, mesh=make_mesh(2))
    one = dwi.dwi_reconstruction(ksp, calib, sens, EPI, device="cpu")
    got = dwi.dwi_reconstruction(ksp, calib, sens, EPI, mesh=CPU2,
                                 device="cpu")
    assert set(got) == set(want) == set(one)
    for key in want:
        assert got[key].shape == want[key].shape, key
        past = int((np.abs(got[key] - want[key])
                    > DWI_REL * np.abs(want[key]).max()).sum())
        assert past <= (1e-3 * want[key].size if key in THRESHOLDED
                        else 0), (key, past)
        np.testing.assert_array_equal(got[key], one[key])


def test_cli_recon_data_parallel_writes_the_one_device_result(tmp_path):
    """``cli.recon --data-parallel 2 --device cpu`` on a 3-slice T2 case
    writes what ``--data-parallel 1`` writes; on cards it asks for as
    many as it is given (none here)."""
    kspace, calib = _t2_case(3, seed=4)
    case_dir = tmp_path / "training" / "T2"
    case_dir.mkdir(parents=True)
    with h5py.File(case_dir / "case0.h5", "w") as hf:
        hf.create_dataset("kspace", data=kspace)
        hf.create_dataset("calibration_data", data=calib)
        hf.create_dataset("ismrmrd_header", data=HDR.encode())
        hf.create_dataset("reconstruction_rss",
                          data=np.zeros((3, 32, 32), np.float32))
        hf.attrs["max"] = 1.0
    outs = {}
    for n in (1, 2):
        out = tmp_path / f"recons_{n}"
        assert cli.main(["--data-path", str(tmp_path), "--output-path",
                         str(out), "--sequence", "t2", "--device", "cpu",
                         "--data-parallel", str(n)]) == 0
        with h5py.File(out / "case0.h5", "r") as hf:
            outs[n] = {k: hf[k][()] for k in hf}
    assert set(outs[2]) == set(outs[1]) == {"reconstruction_rss"}
    assert outs[2]["reconstruction_rss"].shape == (3, 32, 32)
    np.testing.assert_array_equal(outs[2]["reconstruction_rss"],
                                  outs[1]["reconstruction_rss"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 2 devices, have 0"):
            cli.main(["--data-path", str(tmp_path), "--output-path",
                      str(tmp_path / "o"), "--sequence", "t2",
                      "--data-parallel", "2"])


def test_preprocess_volumes_over_devices_bit_equal_and_as_jax():
    """Volume ``i`` on ``devices[i % 3]``: bit-equal to per-volume calls,
    and to JAX's run with its volumes spread over two devices (masks
    bit-equal, tensors within 2e-5). JAX compiles its chain once a device
    (some 7 s each here), so its spread takes two, not four."""
    pairs = [synthetic_kspace_pairs(seed=20 + i, s=4, h=64, w=48)
             for i in range(4)]
    kw = dict(out_size=(32, 32), slice_keep=(0.0, 1.0))
    pre = MRIKneePreprocessor(device="cpu", **kw)
    got = pre.preprocess_volumes_pairs(pairs, devices=["cpu"] * 3)
    want = JaxPreprocessor(**kw).preprocess_volumes_pairs(
        pairs, devices=jax.devices()[:2])
    assert len(got) == len(want) == 4
    for pair, g, w in zip(pairs, got, want):
        one = pre.preprocess_volume_pairs(pair)
        for key in ("tensor", "preview", "mask"):
            torch.testing.assert_close(g[key], one[key], rtol=0, atol=0)
        assert g["indices"] == one["indices"] == list(w["indices"])
        np.testing.assert_array_equal(g["mask"].numpy(), w["mask"])
        assert g["mask"].numpy().any()
        np.testing.assert_allclose(g["tensor"].numpy(), w["tensor"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g["preview"].numpy(), w["preview"],
                                   rtol=2e-5, atol=2e-5)
