"""Parity of the PyTorch port's preprocessing surface with the JAX
package's: multi-coil k-space, the record and image APIs, the many-volume
path with its bfloat16 transfer, N4 and NL-means in the chain, and the
packer's multi-coil volume.

Same seeded numpy inputs through both. Tolerances, with their reasons:
masks bit-equal unless a pixel of the normalized image lies within 1e-6 of
the Otsu threshold (none does here); z-scored tensors and previews to
rtol = atol = 2e-5 (the iFFTs agree to about 1e-6 relative, and the
z-score divides by the in-mask std), and to 5e-4 with N4 and NL-means on
(each adds roundings: 4e-7 and 7e-7 of the range alone,
tests/test_torch_restoration.py, through the z-score's 1/std).
"""
import json

import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.data.preprocess import (
    MRIKneePreprocessor as JaxPreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.data import preprocess
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_knee, synthetic_kspace_pairs, synthetic_multicoil_kspace_pairs)

TOL = dict(rtol=2e-5, atol=2e-5)
KW = dict(out_size=(32, 32), slice_keep=(0.0, 1.0))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_pack(got, want, tol=TOL):
    np.testing.assert_array_equal(_np(got["mask"]), want["mask"])
    assert _np(got["mask"]).any()
    np.testing.assert_allclose(_np(got["tensor"]), want["tensor"], **tol)
    np.testing.assert_allclose(_np(got["preview"]), want["preview"], **tol)
    assert list(got["indices"]) == [int(i) for i in want["indices"]]
    if "sources" in want:
        assert got["sources"] == want["sources"]


@pytest.fixture(scope="module")
def multicoil():
    return synthetic_multicoil_kspace_pairs(seed=5, s=4, c=4, h=64, w=48)


def test_multicoil_volume_matches_jax(multicoil):
    """(S, C, H, W, 2): per-coil iFFT then RSS, through the chain."""
    want = JaxPreprocessor(**KW).preprocess_volume_pairs(multicoil)
    got = MRIKneePreprocessor(device="cpu", **KW).preprocess_volume_pairs(
        multicoil)
    _same_pack(got, want)
    assert got["tensor"].shape == (4, 1, 32, 32)


def test_multicoil_generator_is_seeded_and_knee_shaped():
    a = synthetic_multicoil_kspace_pairs(seed=1, s=2, c=3, h=20, w=16)
    b = synthetic_multicoil_kspace_pairs(seed=1, s=2, c=3, h=20, w=16)
    assert a.shape == (2, 3, 20, 16, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    c = synthetic_multicoil_kspace_pairs(seed=2, s=2, c=3, h=20, w=16)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_preprocess_volumes_pairs_matches_jax(multicoil, dtype):
    """Two volumes (one multi-coil, one single-coil) in one call, each
    equal to JAX's same call; bfloat16 rounds on the host as ml_dtypes
    does, so the two packages see the same bfloat16 input."""
    vols = [multicoil, synthetic_kspace_pairs(seed=9, s=5, h=48, w=40)]
    metas = [None, [{"slice_idx": 10 + i} for i in range(5)]]
    kw = dict(out_size=(32, 32), slice_keep=(0.2, 0.8))
    want = JaxPreprocessor(**kw).preprocess_volumes_pairs(
        vols, metas, transfer_dtype=dtype)
    got = MRIKneePreprocessor(device="cpu", **kw).preprocess_volumes_pairs(
        vols, metas, transfer_dtype=dtype, devices=["cpu"])
    for g, w in zip(got, want):
        _same_pack(g, w)
        assert g["metas"] == w["metas"]
    if dtype == "float32":
        one = MRIKneePreprocessor(device="cpu", **kw
                                  ).preprocess_volume_pairs(vols[1], metas[1])
        assert torch.equal(one["tensor"], got[1]["tensor"])
    with pytest.raises(ValueError):
        MRIKneePreprocessor(device="cpu").preprocess_volumes_pairs(
            vols, transfer_dtype="float16")


def _records(rng, kind):
    if kind == "image":
        return [{"image": synthetic_knee(rng, 40, 36),
                 "meta": {"slice_idx": i}} for i in range(5)]
    if kind == "target":
        return [{"reconstruction_rss": synthetic_knee(rng, 40, 36)[None]}
                for _ in range(5)]
    pair = synthetic_kspace_pairs(seed=4, s=5, h=40, w=36)
    if kind == "kspace_pair":
        return [{"kspace": p} for p in pair]
    if kind == "kspace_complex":
        return [{"kspace": p[..., 0] + 1j * p[..., 1]} for p in pair]
    mc = synthetic_multicoil_kspace_pairs(seed=6, s=5, c=3, h=40, w=36)
    if kind == "multicoil_complex":
        return [{"kspace": p[..., 0] + 1j * p[..., 1]} for p in mc]
    # mixed sources: every record alone
    recs = [{"image": synthetic_knee(rng, 40, 36)} for _ in range(3)]
    return recs + [{"kspace": p} for p in pair[:2]]


@pytest.mark.parametrize("kind", ["image", "target", "kspace_pair",
                                  "kspace_complex", "multicoil_complex",
                                  "mixed"])
def test_preprocess_records_matches_jax(rng, kind):
    records = _records(rng, kind)
    kw = dict(out_size=(32, 32), slice_keep=(0.2, 0.8))
    want = JaxPreprocessor(**kw).preprocess_records(records)
    got = MRIKneePreprocessor(device="cpu", **kw).preprocess_records(records)
    _same_pack(got, want)
    assert got["metas"] == want["metas"]
    one = preprocess.preprocess_record(records[1], device="cpu", **kw)
    w1 = JaxPreprocessor(**kw).preprocess_record(records[1])
    assert one["source"] == w1["source"] and one["meta"] == w1["meta"]
    np.testing.assert_array_equal(one["mask"].numpy(), w1["mask"])
    np.testing.assert_allclose(one["img_z"].numpy(), w1["img_z"], **TOL)
    shim = preprocess.preprocess_records(
        records, preprocessor=MRIKneePreprocessor(device="cpu", **kw))
    assert torch.equal(shim["tensor"], got["tensor"])


def test_preprocess_volume_images_matches_jax(rng):
    imgs = np.stack([synthetic_knee(rng, 48, 40) for _ in range(6)])
    metas = [{"slice_idx": 20 + i} for i in range(6)]
    want = JaxPreprocessor(**KW).preprocess_volume_images(imgs, metas)
    got = MRIKneePreprocessor(device="cpu", **KW).preprocess_volume_images(
        imgs, metas)
    _same_pack(got, want)
    assert got["indices"] == list(range(20, 26))
    with pytest.raises(ValueError):
        MRIKneePreprocessor(device="cpu").preprocess_volume_images(imgs[0])


def test_record_input_rules_match_jax(rng):
    """Source priority, the single-coil iFFT helper and the errors."""
    img = synthetic_knee(rng, 24, 20)
    pair = synthetic_kspace_pairs(seed=2, s=1, h=24, w=20)[0]
    rec = {"kspace": pair, "target": img, "meta": {"a": 1}}
    for cls in (MRIKneePreprocessor, JaxPreprocessor):
        arr, src, meta = cls._normalize_record_input(rec)
        assert src == "target" and meta == {"a": 1}
    bad = [{}, {"image": np.zeros((2, 3, 4))},
           {"kspace": np.zeros((2, 8, 8))}, {"kspace": np.zeros((8, 8))}]
    for r in bad:
        for cls in (MRIKneePreprocessor, JaxPreprocessor):
            with pytest.raises(ValueError):
                cls._normalize_record_input(r)
    cplx = pair[..., 0] + 1j * pair[..., 1]
    np.testing.assert_allclose(
        MRIKneePreprocessor.ifft2c_single(cplx, device="cpu"),
        JaxPreprocessor.ifft2c_single(cplx), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        MRIKneePreprocessor.ifft2c_single(np.zeros((4, 4), np.float32),
                                          device="cpu")
    with pytest.raises(ValueError):
        preprocess.preprocess_record(rec, preprocessor=MRIKneePreprocessor(
            device="cpu"), out_size=(8, 8))


def test_n4_and_denoise_in_the_chain_match_jax():
    """use_n4 and use_denoise run after the body mask and before the
    resize, as in JAX; masks are untouched by both."""
    pair = synthetic_kspace_pairs(seed=12, s=2, h=40, w=36)
    kw = dict(out_size=(32, 32), slice_keep=(0.0, 1.0), use_n4=True,
              use_denoise=True)
    want = JaxPreprocessor(**kw).preprocess_volume_pairs(pair)
    got = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    _same_pack(got, want, dict(rtol=5e-4, atol=5e-4))
    plain = MRIKneePreprocessor(device="cpu", out_size=(32, 32),
                                slice_keep=(0.0, 1.0)
                                ).preprocess_volume_pairs(pair)
    assert torch.equal(plain["mask"], got["mask"])
    assert not torch.allclose(plain["tensor"], got["tensor"])


def test_pack_multicoil_volume_matches_jax_chain(tmp_path, multicoil):
    """The packer takes a multi-coil volume and the preprocessor's own
    settings; what it writes is the JAX chain's result."""
    pre = MRIKneePreprocessor(device="cpu", **KW)
    info = pack_kspace_volume(pre, multicoil, str(tmp_path / "mc"))
    assert info["num_slices"] == 4
    want = JaxPreprocessor(**KW).preprocess_volume_pairs(multicoil)
    with np.load(tmp_path / "mc" / "volume.npz") as z:
        np.testing.assert_array_equal(z["msk"], want["mask"])
        np.testing.assert_allclose(z["img"], want["tensor"], **TOL)
    with open(tmp_path / "mc" / "metas.json", encoding="utf-8") as f:
        assert json.load(f) == [{}] * 4
