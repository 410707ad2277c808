"""Parity of the PyTorch port's training data path with the JAX package:
the slice store, augmentation, the packer, the split and the launcher's
flags.

Tolerances: neighbour tables, gathers, masks, flips and splits exactly
equal; the warp's image within 1e-5 of ``_warp_one`` and its mask equal,
and against the TPU's two-pass warp the bounds of ``test_augment.py``
(interior error < 0.05 on smoothed images, mask disagreement < 2 %);
``save_pack`` arrays equal and ``stats.json`` within 1e-6; the k-space
pack's tensor within 3.5e-6 with masks bit-equal.
"""
import json
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.ndimage import gaussian_filter

from mri_acl_imagesegmentation_adsp_tpu.cli import generate_split as jgs
from mri_acl_imagesegmentation_adsp_tpu.cli import launcher as jlauncher
from mri_acl_imagesegmentation_adsp_tpu.data import hbm_loader as jhbm
from mri_acl_imagesegmentation_adsp_tpu.data.packer import (
    save_pack as jax_save_pack)
from mri_acl_imagesegmentation_adsp_tpu.data.preprocess import (
    MRIKneePreprocessor as JaxPreprocessor)
from mri_acl_imagesegmentation_adsp_tpu.train import augment as jaug
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import generate_split
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.data import hbm_loader
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume, save_pack)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import augment
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)


def _write_packs(tmp_path, sizes, seed=0, hw=(16, 12), label_max=1):
    """Seeded packs of the given slice counts, written by the JAX packer."""
    rng = np.random.default_rng(seed)
    files = []
    for i, s in enumerate(sizes):
        pack = {"tensor": rng.standard_normal((s, 1) + hw).astype(np.float32),
                "mask": rng.integers(0, label_max + 1, (s,) + hw
                                     ).astype(np.uint8),
                "preview": rng.random((s,) + hw).astype(np.float32),
                "indices": list(range(s))}
        d = tmp_path / f"vol{i}"
        jax_save_pack(str(d), pack, preview_max=1)
        files.append(str(d / "volume.npz"))
    return files


# ---------------------------------------------------------------------------
# Slice store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 5])
def test_neighbor_table_and_gather_match_jax(tmp_path, k):
    files = _write_packs(tmp_path, [3, 1, 4])
    want = jhbm.SliceStore.from_files(files)
    got = hbm_loader.SliceStore.from_files(files, workers=2)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.vol_starts, want.vol_starts)
    np.testing.assert_array_equal(got.vol_sizes, want.vol_sizes)
    np.testing.assert_array_equal(got.neighbor_table(k),
                                  want.neighbor_table(k))

    dev = got.to_device(k, device="cpu")
    jdev = want.to_device(k)
    assert dev.masks.dtype == torch.uint8 and dev.num_slices == 8
    idx = np.array([7, 0, 3, 3, 5], np.int32)
    x, y = hbm_loader.gather_batch(dev, torch.from_numpy(idx).long())
    jx, jy = jhbm.gather_batch(jdev.images, jdev.masks, jdev.neighbors,
                               jnp.asarray(idx))
    assert x.shape == (5, k, 16, 12) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(),
                                  np.asarray(jx).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_store_keeps_labels_and_bf16(tmp_path):
    files = _write_packs(tmp_path, [2, 2], label_max=3)
    src = hbm_loader.SliceStore.from_list(_list(tmp_path, files))
    dev = src.to_device(1, torch.bfloat16, "cpu")
    assert dev.images.dtype == torch.bfloat16
    assert dev.masks.dtype == torch.uint8
    np.testing.assert_array_equal(dev.masks.numpy(), src.masks)
    wide = hbm_loader.SliceStore(src.images, src.masks + 300, src.vol_starts,
                                 src.vol_sizes, src.files)
    assert wide.to_device(1, device="cpu").masks.dtype == torch.int32
    with pytest.raises(ValueError):
        src.neighbor_table(2)
    with pytest.raises(ValueError):
        hbm_loader.SliceStore.from_files([])


def _list(tmp_path, files):
    p = tmp_path / "list.txt"
    p.write_text("\n".join(files) + "\n\n")
    assert hbm_loader.read_list(str(p)) == jhbm.read_list(str(p)) == files
    return str(p)


@pytest.mark.parametrize("n,batch,drop_last", [(10, 4, True), (10, 4, False),
                                               (8, 4, False), (3, 4, True)])
def test_epoch_permutation_shape_and_cover(n, batch, drop_last):
    gen = torch.Generator().manual_seed(0)
    perm = hbm_loader.epoch_permutation(gen, n, batch, drop_last)
    want = jhbm.epoch_permutation(jax.random.PRNGKey(0), n, batch, drop_last)
    assert tuple(perm.shape) == tuple(want.shape)
    flat = perm.flatten().tolist()
    if drop_last:
        assert len(set(flat)) == len(flat)
    else:
        assert set(flat) == set(range(n))


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def _fixed_params(b, seed=5, recipe="medium"):
    """JAX-drawn parameters with the warp on for every sample, as both
    packages' AugParams."""
    p = jaug.sample_params(jax.random.PRNGKey(seed), b, recipe)
    p = p._replace(apply_ssr=jnp.ones((b,), bool),
                   hflip=jnp.zeros((b,), bool), vflip=jnp.zeros((b,), bool))
    tp = augment.AugParams(*(torch.from_numpy(np.array(getattr(p, f)))
                             for f in augment.AugParams._fields))
    return p, tp


@pytest.mark.parametrize("recipe", ["light", "medium"])
def test_warp_matches_warp_one(rng, recipe):
    b, h, w, c = 4, 48, 40, 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    msk = np.stack([((yy - 20 - i) ** 2 + (xx - 20) ** 2 < 130)
                    for i in range(b)]).astype(np.uint8)
    p, tp = _fixed_params(b, seed=3, recipe=recipe)
    xg, yg = jax.vmap(lambda img, m, *lp: jaug._warp_one(
        img, m, type(p)(*lp), h, w))(jnp.asarray(x), jnp.asarray(msk), *p)
    xt, yt = augment.apply_params(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(msk), tp)
    err = np.abs(xt.numpy().transpose(0, 2, 3, 1) - np.asarray(xg)).max()
    assert err <= 1e-5, err
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yg))
    assert yt.dtype == torch.uint8


def test_warp_within_bounds_of_the_tpu_separable_warp(rng):
    """The bounds ``test_augment.py`` holds the two JAX warps to."""
    b, h, w, c = 4, 48, 40, 2
    x = gaussian_filter(rng.standard_normal((b, h, w, c)).astype(np.float32),
                        sigma=(0, 2.0, 2.0, 0)).astype(np.float32) * 4.0
    yy, xx = np.mgrid[:h, :w]
    msk = np.stack([((yy - 20 - i) ** 2 + (xx - 20) ** 2 < 130)
                    for i in range(b)]).astype(np.int32)
    p, tp = _fixed_params(b)
    xs, ys = jaug._warp_batch_separable(jnp.asarray(x), jnp.asarray(msk), p,
                                        h, w)
    xt, yt = augment.warp_affine(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(msk), tp)
    xs, ys = np.asarray(xs), np.asarray(ys)
    xt, yt = xt.numpy().transpose(0, 2, 3, 1), yt.numpy()
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(b):
        dy = yy - cy - float(p.shift_y[i]) * h
        dx = xx - cx - float(p.shift_x[i]) * w
        cos, sin = np.cos(-float(p.angle[i])), np.sin(-float(p.angle[i]))
        sy = (sin * dx + cos * dy) / float(p.scale[i]) + cy
        sx = (cos * dx - sin * dy) / float(p.scale[i]) + cx
        inside = (sy > 1.5) & (sy < h - 2.5) & (sx > 1.5) & (sx < w - 2.5)
        assert np.abs(xt[i] - xs[i]).max(axis=-1)[inside].max() < 0.05
        assert (yt[i] != ys[i])[inside].mean() < 0.02


def test_flips_are_exact_and_ungated_samples_pass_through(rng):
    b, c, h, w = 4, 3, 10, 7
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (b, h, w)).astype(np.uint8))
    f = torch.tensor([True, False, True, False])
    v = torch.tensor([False, False, True, True])
    z = torch.zeros(b)
    p = augment.AugParams(f, v, torch.zeros(b, dtype=torch.bool), z, z,
                          torch.ones(b), z)
    xo, yo = augment.apply_params(x, y, p)
    xn, yn = x.numpy(), y.numpy()
    for i in range(b):
        xe, ye = xn[i], yn[i]
        if f[i]:
            xe, ye = xe[:, :, ::-1], ye[:, ::-1]
        if v[i]:
            xe, ye = xe[:, ::-1], ye[::-1]
        np.testing.assert_array_equal(xo[i].numpy(), xe)
        np.testing.assert_array_equal(yo[i].numpy(), ye)


@pytest.mark.parametrize("recipe", ["light", "medium"])
def test_sample_params_within_recipe(recipe):
    cfg = jaug._RECIPES[recipe]
    p = augment.sample_params(torch.Generator().manual_seed(1), 4000, recipe)
    assert float(p.shift_y.abs().max()) <= cfg["shift"]
    assert float(p.shift_x.abs().max()) <= cfg["shift"]
    assert float((p.scale - 1).abs().max()) <= cfg["scale"] + 1e-6
    assert float(p.angle.abs().max()) <= np.deg2rad(cfg["rot_deg"]) + 1e-6
    for flag, prob in ((p.hflip, cfg["hflip_p"]), (p.vflip, cfg["vflip_p"]),
                       (p.apply_ssr, cfg["ssr_p"])):
        assert abs(float(flag.float().mean()) - prob) < 0.03


def test_augment_none_is_identity_and_heavy_waits(rng):
    """``none`` is the identity; ``heavy`` (ported: elastic, checked against
    JAX in ``test_torch_parallel_mesh.py``) keeps shapes and dtypes, draws
    an elastic seed a sample and is reproducible from the generator's
    seed; an unknown recipe raises."""
    x = torch.from_numpy(rng.standard_normal((2, 1, 8, 8)).astype(np.float32))
    y = torch.zeros((2, 8, 8), dtype=torch.uint8)
    xo, yo = augment.augment_batch(x, y, None, "none")
    assert xo is x and yo is y
    outs = [augment.augment_batch(x, y, torch.Generator().manual_seed(4),
                                  "heavy") for _ in range(2)]
    for xh, yh in outs:
        assert xh.shape == x.shape and yh.shape == y.shape
        assert xh.dtype == x.dtype and yh.dtype == y.dtype
    assert torch.equal(outs[0][0], outs[1][0])
    p = augment.sample_params(torch.Generator().manual_seed(4), 64, "heavy")
    assert 0.3 < float(p.apply_elastic.float().mean()) < 0.7
    assert len(set(p.elastic_seed.tolist())) == 64
    with pytest.raises(ValueError):
        augment.check_recipe("strong")


# ---------------------------------------------------------------------------
# Packer
# ---------------------------------------------------------------------------

def test_save_pack_matches_jax(tmp_path, rng):
    s, h, w = 5, 24, 20
    tensor = rng.standard_normal((s, 1, h, w)).astype(np.float32)
    mask = (rng.random((s, h, w)) > 0.4).astype(np.uint8)
    mask[2] = 0   # an empty slice gives NaN stats
    pack = {"tensor": tensor, "mask": mask,
            "preview": rng.random((s, h, w)).astype(np.float32),
            "indices": [3, 4, 5, 6, 7], "metas": [{"slice_idx": i}
                                                  for i in range(s)]}
    jax_save_pack(str(tmp_path / "jax"), pack, preview_max=3)
    torch_pack = dict(pack, tensor=torch.from_numpy(tensor),
                      mask=torch.from_numpy(mask))
    save_pack(str(tmp_path / "port"), torch_pack, preview_max=3)
    j, p = tmp_path / "jax", tmp_path / "port"
    assert (sorted(x.name for x in p.iterdir())
            == sorted(x.name for x in j.iterdir()))
    with np.load(j / "volume.npz") as a, np.load(p / "volume.npz") as b:
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["msk"], b["msk"])
        assert b["msk"].dtype == np.uint8
    np.testing.assert_array_equal(np.load(j / "mask.npy"),
                                  np.load(p / "mask.npy"))
    np.testing.assert_array_equal(torch.load(j / "tensor.pt").numpy(),
                                  torch.load(p / "tensor.pt").numpy())
    for name in ("indices.json", "metas.json"):
        assert json.loads((j / name).read_text()) == json.loads(
            (p / name).read_text())
    assert (sorted(x.name for x in (p / "preview").iterdir())
            == ["slice_003.png", "slice_004.png", "slice_005.png"])
    for f in (j / "preview").iterdir():
        np.testing.assert_array_equal(np.asarray(Image.open(f)),
                                      np.asarray(Image.open(
                                          p / "preview" / f.name)))
    js, ps = (json.loads((d / "stats.json").read_text()) for d in (j, p))
    assert js.keys() == ps.keys() and js["count_slices"] == ps["count_slices"]
    for key in ("mean_in_mask_mean", "mean_in_mask_std", "per_slice_mean",
                "per_slice_std"):
        np.testing.assert_allclose(ps[key], js[key], rtol=1e-6, atol=1e-6)


def test_pack_kspace_volume_matches_jax_chain(tmp_path):
    pair = synthetic_kspace_pairs(seed=11, s=8, h=64, w=48)
    kw = dict(out_size=(32, 32), slice_keep=(0.3, 0.7))
    jax_save_pack(str(tmp_path / "jax"),
                  JaxPreprocessor(**kw).preprocess_volume_pairs(pair))
    info = pack_kspace_volume(MRIKneePreprocessor(device="cpu", **kw), pair,
                              str(tmp_path / "port"))
    assert info["num_slices"] == 3
    j, p = tmp_path / "jax", tmp_path / "port"
    with np.load(j / "volume.npz") as a, np.load(p / "volume.npz") as b:
        np.testing.assert_array_equal(b["msk"], a["msk"])
        assert b["msk"].any()
        err = np.abs(b["img"] - a["img"]).max()
        assert err <= 3.5e-6, err
    for name in ("indices.json", "metas.json"):
        assert json.loads((j / name).read_text()) == json.loads(
            (p / name).read_text())


# ---------------------------------------------------------------------------
# Split and launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 2024])
def test_split_volumes_matches_jax(seed):
    for n in range(1, 8):
        files = [f"/a/vol{i}/volume.npz" for i in range(n)]
        for ratio in (0.5, 0.8):
            assert launcher.split_volumes(files, ratio, seed) == \
                jlauncher.split_volumes(files, ratio, seed)


def test_generate_split_cli_matches_jax(tmp_path):
    files = _write_packs(tmp_path / "art", [1] * 6)
    assert len(files) == 6
    outs = {}
    for name, mod in (("jax", jgs), ("port", generate_split)):
        state = random.getstate()
        assert mod.main(["--artifact-dir", str(tmp_path / "art"),
                         "--output-dir", str(tmp_path / name),
                         "--all-file", str(tmp_path / f"{name}.txt")]) == 0
        random.setstate(state)
        outs[name] = [(tmp_path / name / f).read_text()
                      for f in ("train.txt", "val.txt")]
    assert outs["jax"] == outs["port"]
    launcher.generate_split(tmp_path / "art", tmp_path / "lists", 0.8, 42)
    jlauncher.generate_split(tmp_path / "art", tmp_path / "jlists", 0.8, 42)
    for f in ("train.txt", "val.txt"):
        assert ((tmp_path / "lists" / f).read_text()
                == (tmp_path / "jlists" / f).read_text())


def test_launcher_has_the_jax_flags_and_defaults():
    ours, theirs = launcher.build_parser(), jlauncher.build_parser()
    flags = {s for a in theirs._actions for s in a.option_strings}
    assert flags <= {s for a in ours._actions for s in a.option_strings}
    ns, jns = ours.parse_args([]), theirs.parse_args([])
    for key, value in vars(jns).items():
        if key != "dataset_root":
            assert getattr(ns, key) == value, key
    assert ns.device == "cuda"
    with pytest.raises(SystemExit):      # no abbreviations
        ours.parse_args(["--batch", "4"])
    argv = ["--preset", "tuned-v5e", "--lr=2e-3"]
    ns = launcher.apply_preset(ours, ours.parse_args(argv), argv)
    assert ns.batch_size == 128 and ns.lr == 2e-3


def test_launcher_preprocess_stage_names_the_missing_adapters(
        capsys, monkeypatch, tmp_path):
    """The preprocess stage runs now; what it can lack is named: the
    dataset root, or h5py, which the .h5 adapter needs."""
    monkeypatch.delenv("FASTMRI_ROOT", raising=False)
    with pytest.raises(SystemExit):
        launcher.main(["--device", "cpu"])
    assert "--dataset-root" in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        launcher.main(["--dataset-root", str(tmp_path), "--device", "cpu",
                       "--artifact-dir", str(tmp_path / "art")])
