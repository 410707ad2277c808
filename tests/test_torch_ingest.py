"""The port's .h5 ingest route against the JAX package's: the native npz and
HDF5 readers (bit-equal to numpy, h5py and the JAX readers), the refusal
where h5py is missing, the prefetcher, both adapters, the launcher's
preprocess stage with --skip-existing, the pickle adapter through
build_preprocess, TrainerDataset and the slice store's native loads.

Tolerances: readers, adapters and masks bit-equal; the z-scored pack
tensors within 1e-5 (the chains are the same functions in two frameworks,
f32).
"""
import json
import os
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from mri_acl_imagesegmentation_adsp_tpu import native as jnative  # noqa: E402
from mri_acl_imagesegmentation_adsp_tpu.cli import (  # noqa: E402
    launcher as jlauncher)
from mri_acl_imagesegmentation_adsp_tpu.data import (  # noqa: E402
    adapters as jadapters)
from mri_acl_imagesegmentation_adsp_tpu.data import (  # noqa: E402
    hbm_loader as jhbm)
from mri_acl_imagesegmentation_adsp_tpu.data import (  # noqa: E402
    trainer_dataset as jtd)
from mri_acl_imagesegmentation_adsp_tpu.data.packer import (  # noqa: E402
    group_records_by_file as jgroup, save_pack as jsave_pack)
from mri_acl_imagesegmentation_adsp_tpu.data.preprocess import (  # noqa: E402
    MRIKneePreprocessor as JPre)
from mri_acl_imagesegmentation_adsp_tpu_torch import native  # noqa: E402
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import (  # noqa: E402
    launcher)
from mri_acl_imagesegmentation_adsp_tpu_torch.data import (  # noqa: E402
    adapters, hbm_loader, packer, prefetch, recon_data, trainer_dataset)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (  # noqa: E402
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.native import (  # noqa: E402
    _build, h5loader, loader)

sys.path.insert(0, str(Path(__file__).parent))
from oracles import (synthetic_kspace_volume,  # noqa: E402
                     write_fake_fastmri_h5)

TENSOR_TOL = 1e-5
PORT = Path(loader.__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Native npz loader
# ---------------------------------------------------------------------------

def _npz(path, compressed, img, msk):
    (np.savez_compressed if compressed else np.savez)(path, img=img, msk=msk)
    return str(path)


@pytest.mark.parametrize("compressed", [True, False])
def test_native_npz_loader_equals_numpy_and_jax(tmp_path, rng, compressed):
    img = rng.standard_normal((5, 1, 24, 20)).astype(np.float32)
    msk = (rng.integers(0, 5, (5, 24, 20))).astype(
        np.uint8 if compressed else np.int64)
    path = _npz(tmp_path / "volume.npz", compressed, img, msk)
    assert native.native_available()
    for member, want in (("img.npy", img), ("msk.npy", msk)):
        got = native.load_npz_member(path, member)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jnative.load_npz_member(path, member))
    got = native.load_volume_npz(path)
    for a, b, c in zip(got, (img, msk), jnative.load_volume_npz(path)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert native.load_npz_member(path, "other.npy") is None


def test_native_bulk_npz_loader_aligns_and_marks_bad_paths(tmp_path, rng):
    paths = [_npz(tmp_path / f"v{v}.npz", True,
                  rng.standard_normal((3 + v, 1, 16, 16)).astype(np.float32),
                  (rng.random((3 + v, 16, 16)) > 0.5).astype(np.uint8))
             for v in range(4)]
    bulk = native.load_volumes_npz(paths + [str(tmp_path / "nope.npz")],
                                   threads=3)
    want = jnative.load_volumes_npz(paths, threads=3)
    assert len(bulk) == 5 and bulk[4] is None
    for (x, y), (jx, jy), p in zip(bulk, want, paths):
        with np.load(p) as z:
            np.testing.assert_array_equal(x, z["img"])
            np.testing.assert_array_equal(y, z["msk"])
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert native.load_volumes_npz([]) == []


def test_native_libraries_build_in_the_ignored_build_directory():
    """Both libraries are built from the port's own sources into
    build/native/ at the checkout's root, never beside the sources."""
    assert native.native_available() and native.native_h5_available()
    for name, libs in (("npz_loader", ["-lz"]),
                       ("h5_reader", ["-lz", "-ldl"])):
        so = _build.library_path(name, libs)
        assert so.is_file() and so.parent == _build.BUILD_DIR
        assert (PORT / "native" / f"{name}.cc").is_file()
    assert _build.BUILD_DIR == PORT.parent / "build" / "native"
    assert not list((PORT / "native").glob("*.so"))
    ignored = (PORT.parent / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_slice_store_loads_through_the_native_loader(tmp_path, rng,
                                                     monkeypatch):
    files = [_npz(tmp_path / f"s{v}.npz", True,
                  rng.standard_normal((4, 1, 12, 12)).astype(np.float32),
                  (rng.random((4, 12, 12)) > 0.5).astype(np.uint8))
             for v in range(3)]
    want = jhbm.SliceStore.from_files(files, workers=0)
    calls = []
    monkeypatch.setattr(hbm_loader, "load_volumes_npz", lambda *a, **k: (
        calls.append("bulk"), loader.load_volumes_npz(*a, **k))[1])
    monkeypatch.setattr(hbm_loader, "load_volume_npz", lambda p: (
        calls.append("one"), loader.load_volume_npz(p))[1])
    for workers in (0, 4):
        got = hbm_loader.SliceStore.from_files(files, workers=workers)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.masks, want.masks)
        np.testing.assert_array_equal(got.vol_sizes, want.vol_sizes)
    assert calls == ["one"] * 3 + ["bulk"]
    # where the native loader is unavailable, np.load serves
    monkeypatch.setattr(hbm_loader, "load_volumes_npz", lambda *a, **k: None)
    monkeypatch.setattr(hbm_loader, "load_volume_npz", lambda p: None)
    for workers in (0, 2):
        got = hbm_loader.SliceStore.from_files(files, workers=workers)
        np.testing.assert_array_equal(got.images, want.images)


# ---------------------------------------------------------------------------
# Native HDF5 slab reader (the fixtures of tests/test_h5_reader.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("h5") / "fixture.h5"
    rng = np.random.default_rng(7)
    data = {
        "kspace": ((rng.standard_normal((5, 7, 3, 24, 18))
                    + 1j * rng.standard_normal((5, 7, 3, 24, 18)))
                   .astype(np.complex64),
                   dict(chunks=(2, 3, 2, 10, 7), compression="gzip")),
        "contig": (rng.standard_normal((6, 11, 9)).astype(np.float32), {}),
        "shuffled": (rng.integers(-500, 500, (4, 13, 6)).astype(np.int16),
                     dict(chunks=(3, 5, 6), compression="gzip",
                          shuffle=True)),
        "onedim": (rng.standard_normal(17).astype(np.float64),
                   dict(chunks=(4,), compression="gzip")),
        "fletcher": (rng.standard_normal((4, 8)).astype(np.float32),
                     dict(chunks=(2, 8), fletcher32=True)),
    }
    with h5py.File(p, "w") as f:
        for name, (arr, kw) in data.items():
            f.create_dataset(name, data=arr, **kw)
    return p, data


@pytest.mark.parametrize("dset,axis,idx", [
    ("kspace", 1, [3]),
    ("kspace", 1, [6, 0, 4]),
    ("kspace", 0, list(range(5))),
    ("kspace", 4, [17, 2]),
    ("contig", 0, [5, 1]),
    ("contig", 2, [8, 0, 3]),
    ("shuffled", 0, [2, 1]),
    ("shuffled", 2, [5, 4, 0]),
    ("onedim", 0, [16, 3, 0]),
])
def test_native_h5_reader_equals_h5py_and_jax(fixture_file, dset, axis, idx):
    p, data = fixture_file
    got = native.read_h5_slab(str(p), dset, idx, axis=axis)
    assert got is not None, "the native path fell back"
    want = np.take(data[dset][0], idx, axis=axis)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.read_h5_slab(str(p), dset, idx, axis=axis))
    np.testing.assert_array_equal(
        native.load_h5_slab(str(p), dset, idx, axis=axis), want)


def test_native_h5_reader_declines_what_it_does_not_serve(fixture_file):
    p, data = fixture_file
    assert native.read_h5_slab(str(p), "fletcher", [1], axis=0) is None
    np.testing.assert_array_equal(
        native.load_h5_slab(str(p), "fletcher", [3, 1], axis=0),
        data["fletcher"][0][[3, 1]])
    assert native.read_h5_slab(str(p), "missing_dataset", [0]) is None
    assert native.read_h5_slab(str(p), "kspace", [99], axis=1) is None
    assert native.read_h5_slab(str(p), "kspace", [1, 1], axis=1) is None
    assert native.read_h5_slab(str(p), "kspace", [], axis=1) is None
    assert native.read_h5_slab("/nonexistent/file.h5", "kspace", [0]) is None
    np.testing.assert_array_equal(
        native.load_h5_slab(str(p), "contig", [7, 2], axis=-2),
        data["contig"][0][:, [7, 2]])
    np.testing.assert_array_equal(
        native.load_h5_slab(str(p), "contig", [3, 3, 1], axis=0),
        data["contig"][0][[3, 3, 1]])


def test_native_h5_reader_serves_a_rewritten_file_anew(tmp_path):
    p = tmp_path / "rw.h5"
    for round_ in range(2):
        arr = np.full((3, 8), float(round_), np.float32)
        with h5py.File(p, "w") as f:
            f.create_dataset("d", data=arr, chunks=(2, 8),
                             compression="gzip")
        np.testing.assert_array_equal(
            native.load_h5_slab(str(p), "d", [1], axis=0), arr[[1]])


def _fake_fastmri_root(tmp_path, n=3, s=6, h=48, w=40, target=(True,)):
    """``n`` fake fastMRI volumes; volume ``i`` holds a target where
    ``target[i % len(target)]``."""
    root = tmp_path / "raw"
    root.mkdir()
    rng = np.random.default_rng(11)
    for i in range(n):
        ksp, imgs = synthetic_kspace_volume(rng, s=s, h=h, w=w)
        write_fake_fastmri_h5(str(root / f"file{i:03d}.h5"), ksp,
                              target=imgs if target[i % len(target)]
                              else None)
    return root


def test_h5_entry_points_name_h5py_where_it_is_missing(tmp_path, fixture_file,
                                                       monkeypatch):
    """No system libhdf5 and no h5py, as on a machine that has neither:
    every .h5 entry point raises an ImportError naming h5py; the npz
    loader and the pickle adapter still serve."""
    root = _fake_fastmri_root(tmp_path, n=1, s=2)
    p, _ = fixture_file
    monkeypatch.setattr(h5loader, "_lib", "unavailable")
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not native.native_h5_available()
    assert native.read_h5_slab(str(p), "contig", [0]) is None
    with pytest.raises(ImportError, match="h5py"):
        native.load_h5_slab(str(p), "contig", [0])
    ad = adapters.FastMRISinglecoilAdapter(root_dir=str(root))
    fp = str(root / "file000.h5")
    for call in (ad.discover_records,
                 lambda: ad.load_record({"filepath": fp, "slice_idx": 0}),
                 lambda: ad.load_volume(fp),
                 lambda: recon_data.load_file_T2(fp),
                 lambda: recon_data.load_file_dwi(fp),
                 lambda: recon_data.save_recon({}, str(tmp_path / "o.h5")),
                 lambda: launcher.run_preprocess(
                     root, tmp_path / "art", 32, 32, "0.3,0.7", "1.0,99.5",
                     False, False, 0, device="cpu")):
        with pytest.raises(ImportError, match="h5py"):
            call()
    assert native.native_available()


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_order_and_length():
    class Squares:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return i * i

    pf = prefetch.Prefetcher(Squares(), depth=4, workers=3)
    assert len(pf) == 23
    assert list(pf) == [i * i for i in range(23)]
    assert list(pf) == [i * i for i in range(23)]  # reusable
    assert prefetch.prefetch(Squares(), 0).__class__ is Squares
    assert isinstance(prefetch.prefetch(Squares(), 2), prefetch.Prefetcher)
    assert list(prefetch.Prefetcher([], depth=1)) == []
    with pytest.raises(ValueError):
        prefetch.Prefetcher(Squares(), depth=0)


def test_prefetcher_raises_a_worker_error_at_its_index():
    class Boom:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            if i == 3:
                raise RuntimeError("bad record")
            return i

    out = []
    with pytest.raises(RuntimeError, match="bad record"):
        for x in prefetch.Prefetcher(Boom(), depth=2, workers=2):
            out.append(x)
    assert out == [0, 1, 2]


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------

def _assert_records_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key


def test_fastmri_adapter_equals_jax(tmp_path, monkeypatch):
    root = _fake_fastmri_root(tmp_path, n=2, s=4, target=(True, False))
    ours = adapters.FastMRISinglecoilAdapter(root_dir=str(root))
    theirs = jadapters.FastMRISinglecoilAdapter(root_dir=str(root))
    recs = ours.discover_records()
    assert recs == theirs.discover_records() and len(recs) == 8
    for rec in (recs[1], recs[6]):
        _assert_records_equal(ours.load_record(rec), theirs.load_record(rec))
    for fp in sorted({r["filepath"] for r in recs}):
        got, want = ours.load_volume(fp), theirs.load_volume(fp)
        np.testing.assert_array_equal(got["kspace_pair"],
                                      want["kspace_pair"])
        assert got["kspace_pair"].dtype == np.float32
        assert (got["target"] is None) == (want["target"] is None)
        if want["target"] is not None:
            np.testing.assert_array_equal(got["target"], want["target"])
        assert got["metas"] == want["metas"]
    assert packer.group_records_by_file(recs) == jgroup(recs[::-1])
    monkeypatch.delenv("FASTMRI_ROOT", raising=False)
    with pytest.raises(ValueError, match="FASTMRI_ROOT"):
        adapters.FastMRISinglecoilAdapter()
    monkeypatch.setenv("FASTMRI_ROOT", str(root))
    assert adapters.FastMRISinglecoilAdapter().root_dir == str(root)


def _write_pickles(tmp_path, rng):
    imgs = rng.integers(0, 255, (4, 20, 20)).astype(np.uint8)
    labels = [0, 1, 2, 1]
    (tmp_path / "sub").mkdir()
    with open(tmp_path / "dictstyle.pck", "wb") as f:
        pickle.dump({"data": imgs, "labels": labels}, f)
    with open(tmp_path / "sub" / "liststyle.pickle", "wb") as f:
        pickle.dump([(imgs[i], labels[i]) for i in range(2)]
                    + [imgs[2]], f)
    with open(tmp_path / "fallback.pck", "wb") as f:
        pickle.dump({"weird_name": imgs[:3]}, f)
    return imgs


def test_knee_pck_adapter_equals_jax(tmp_path, rng):
    _write_pickles(tmp_path, rng)
    ours, theirs = adapters.KneePckAdapter(), jadapters.KneePckAdapter()
    recs = ours.discover_records(str(tmp_path))
    assert recs == theirs.discover_records(str(tmp_path))
    assert len(recs) == 4 + 3 + 3
    for rec in recs:
        _assert_records_equal(ours.load_record(rec), theirs.load_record(rec))
    with open(tmp_path / "bad.pck", "wb") as f:
        pickle.dump(42, f)
    with pytest.raises(ValueError, match="Unsupported pickle root"):
        ours.discover_records(str(tmp_path))


# ---------------------------------------------------------------------------
# The launcher's preprocess stage and build_preprocess
# ---------------------------------------------------------------------------

PREP = dict(height=32, width=32, slice_keep="0.3,0.7", clip="1.0,99.5",
            use_n4=False, use_denoise=False, preview_max=2)


def _assert_packs_equal(got_dir, want_dir):
    with np.load(got_dir / "volume.npz") as a, \
            np.load(want_dir / "volume.npz") as b:
        np.testing.assert_array_equal(a["msk"], b["msk"])
        assert a["img"].shape == b["img"].shape
        assert np.abs(a["img"] - b["img"]).max() <= TENSOR_TOL
        assert 0 < a["msk"].sum() < a["msk"].size
    got, want = (json.loads((d / "stats.json").read_text())
                 for d in (got_dir, want_dir))
    assert got.keys() == want.keys()
    assert got["count_slices"] == want["count_slices"]
    assert len(got["per_slice_mean"]) == len(want["per_slice_mean"])
    for name in ("indices.json", "metas.json"):
        assert ((got_dir / name).read_text()
                == (want_dir / name).read_text())
    assert (sorted(p.name for p in (got_dir / "preview").iterdir())
            == sorted(p.name for p in (want_dir / "preview").iterdir()))
    np.testing.assert_array_equal(np.load(got_dir / "mask.npy"),
                                  np.load(want_dir / "mask.npy"))


def test_launcher_preprocess_stage_equals_jax(tmp_path):
    """Three .h5 files, two with a reconstruction target (it outranks the
    k-space) and one without: the port's packs are the JAX launcher's."""
    root = _fake_fastmri_root(tmp_path, target=(True, False))
    args = [PREP[k] for k in ("height", "width", "slice_keep", "clip",
                              "use_n4", "use_denoise", "preview_max")]
    assert launcher.run_preprocess(root, tmp_path / "port", *args,
                                   device="cpu") == 3
    assert jlauncher.run_preprocess(root, tmp_path / "jax", *args) == 3
    for i in range(3):
        name = f"file{i:03d}"
        _assert_packs_equal(tmp_path / "port" / name, tmp_path / "jax" / name)
    metas = json.loads((tmp_path / "port" / "file001" / "metas.json"
                        ).read_text())
    assert metas[0]["target_key"] is None


def test_skip_existing_redoes_only_the_incomplete_pack(tmp_path):
    root = _fake_fastmri_root(tmp_path, s=4)
    spec = dict(root_dir=str(root), out_dir=str(tmp_path / "art"),
                device="cpu", **PREP)
    adapter = adapters.FastMRISinglecoilAdapter(root_dir=str(root))
    first = packer.build_preprocess(SimpleNamespace(**spec), adapter)
    assert len(first) == 3
    assert not any(e.get("skipped_existing") for e in first)
    mtimes = {e["npz_path"]: os.path.getmtime(e["npz_path"]) for e in first}
    again = packer.build_preprocess(
        SimpleNamespace(**spec, skip_existing=True), adapter)
    assert all(e.get("skipped_existing") for e in again)
    assert [e["num_slices"] for e in again] == [e["num_slices"]
                                               for e in first]
    assert all(os.path.getmtime(p) == t for p, t in mtimes.items())
    os.remove(Path(first[1]["output_dir"]) / "stats.json")
    third = packer.build_preprocess(
        SimpleNamespace(**spec, skip_existing=True), adapter)
    redone = [e for e in third if not e.get("skipped_existing")]
    assert [e["output_dir"] for e in redone] == [first[1]["output_dir"]]
    assert (Path(first[1]["output_dir"]) / "stats.json").is_file()
    for i in (0, 2):
        p = first[i]["npz_path"]
        assert os.path.getmtime(p) == mtimes[p]


def test_launcher_runs_preprocess_split_and_train_on_h5(tmp_path):
    """The launcher from .h5 files to a trained run, without
    --skip-preprocess, on the CPU."""
    root = _fake_fastmri_root(tmp_path, n=3, s=10, h=64, w=48)
    assert launcher.main([
        "--dataset-root", str(root), "--artifact-dir", str(tmp_path / "art"),
        "--list-dir", str(tmp_path / "lists"),
        "--out-dir", str(tmp_path / "run"), "--height", "32", "--width",
        "32", "--epochs", "1", "--batch-size", "2", "--encoder", "resnet18",
        "--no-amp", "--device", "cpu"]) == 0
    assert len(list((tmp_path / "art").rglob("volume.npz"))) == 3
    for f in ("train.txt", "val.txt"):
        assert (tmp_path / "lists" / f).read_text()
    assert (tmp_path / "run" / "best.ckpt").is_file()
    summary = json.loads((tmp_path / "run" / "summary.json").read_text())
    assert np.isfinite(summary["best"]["val_dice"])


def _pck_volumes(tmp_path, n=2, s=6, h=48, w=40):
    """Pickled magnitude volumes ``{"data": (S, H, W) f32}``, one file a
    volume."""
    root = tmp_path / "pck"
    root.mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        _, imgs = synthetic_kspace_volume(rng, s=s, h=h, w=w)
        with open(root / f"vol{i}.pck", "wb") as f:
            pickle.dump({"data": imgs.astype(np.float32)}, f)
    return root


def test_build_preprocess_packs_pickled_volumes_as_jax_preprocesses_them(
        tmp_path):
    """The pickle adapter's records through build_preprocess, one pack a
    file. The JAX build_preprocess groups records by ``filepath`` only and
    fails on them; its preprocess_records on the same records, one file at
    a time, is the reference."""
    root = _pck_volumes(tmp_path)
    out = packer.build_preprocess(SimpleNamespace(
        root_dir=str(root), out_dir=str(tmp_path / "port"), device="cpu",
        **PREP), adapters.KneePckAdapter())
    assert [Path(e["filepath"]).name for e in out] == ["vol0.pck",
                                                        "vol1.pck"]
    jad = jadapters.KneePckAdapter()
    recs = jad.discover_records(str(root))
    with pytest.raises(KeyError):
        jgroup(recs)
    jpre = JPre(out_size=(32, 32), slice_keep=(0.3, 0.7))
    for i in range(2):
        mine = [r for r in recs if Path(r["pck_path"]).stem == f"vol{i}"]
        pack = jpre.preprocess_records([jad.load_record(r) for r in mine])
        want = tmp_path / "jax" / f"vol{i}"
        jsave_pack(str(want), pack, preview_max=PREP["preview_max"])
        _assert_packs_equal(tmp_path / "port" / f"vol{i}", want)


# ---------------------------------------------------------------------------
# TrainerDataset
# ---------------------------------------------------------------------------

def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key]
        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        if isinstance(value, np.ndarray) or hasattr(value, "shape"):
            value = np.asarray(value)
            if key == "mask":
                np.testing.assert_array_equal(g, value)
            else:
                assert np.abs(np.asarray(g, np.float64)
                              - value).max() <= TENSOR_TOL, key
        else:
            assert g == value, key


def test_trainer_dataset_samples_equal_jax(tmp_path):
    root = _fake_fastmri_root(tmp_path, n=2, s=3, target=(False, True))
    ours = trainer_dataset.TrainerDataset(
        adapters.FastMRISinglecoilAdapter(root_dir=str(root)),
        preprocessor=MRIKneePreprocessor(out_size=(32, 32), device="cpu"))
    theirs = jtd.TrainerDataset(
        jadapters.FastMRISinglecoilAdapter(root_dir=str(root)),
        preprocessor=JPre(out_size=(32, 32)))
    assert len(ours) == len(theirs) == 6
    for i in (0, 4):
        _assert_samples_equal(ours[i], theirs[i])
    raw = trainer_dataset.TrainerDataset(
        adapters.FastMRISinglecoilAdapter(root_dir=str(root)))
    jraw = jtd.TrainerDataset(
        jadapters.FastMRISinglecoilAdapter(root_dir=str(root)))
    for i in (1, 5):
        _assert_samples_equal(raw[i], jraw[i])
    fn = trainer_dataset.TrainerDataset(
        adapters.FastMRISinglecoilAdapter(root_dir=str(root)),
        preprocessor=lambda rec: {"img_z": rec["kspace"].real, "meta": {}})
    assert fn[2]["meta"]["slice_idx"] == 2
    with pytest.raises(TypeError):
        trainer_dataset.TrainerDataset(
            adapters.FastMRISinglecoilAdapter(root_dir=str(root)),
            preprocessor=3)[0]
