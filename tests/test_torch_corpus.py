"""The synthetic corpus made in memory: the port's generator against the
oracle of ``scripts/make_corpus.py``, the in-memory pack against the JAX
launcher's ``.h5`` preprocess route, resumable corpus making with the JAX
split's names, and ``tools/corpus_run.py``'s settings against the
committed JAX runs' ``args.json``.

Tolerances: the generator bit-equal; packs: masks bit-equal, the z-scored
tensor within 1e-5 (the chains are the same functions in two frameworks,
f32).
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from mri_acl_imagesegmentation_adsp_tpu.cli import launcher as jlauncher
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.tools import (
    corpus_run, make_corpus)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.trainer import UNet2DArgs
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs, synthetic_knee_volume)

sys.path.insert(0, str(Path(__file__).parent))
from oracles import (synthetic_kspace_volume,  # noqa: E402
                     write_fake_fastmri_h5)

REPO = Path(__file__).resolve().parents[1]
TENSOR_TOL = 1e-5


@pytest.mark.parametrize("seed", [2024, 2031])
def test_corpus_generator_is_the_oracle(seed):
    """Volume ``i`` of ``scripts/make_corpus.py`` is the oracle's volume of
    ``default_rng(2024 + i)``: its images and its complex64 k-space as a
    real/imag pair, bit for bit."""
    ksp, imgs = synthetic_kspace_volume(np.random.default_rng(seed), s=3,
                                        h=368, w=320)
    np.testing.assert_array_equal(synthetic_knee_volume(seed, 3, 368, 320),
                                  imgs)
    pair = synthetic_kspace_pairs(seed, s=3, h=368, w=320)
    assert pair.dtype == np.float32
    np.testing.assert_array_equal(pair, np.stack([ksp.real, ksp.imag], -1))


def test_in_memory_pack_equals_the_h5_route(tmp_path):
    """The JAX launcher's preprocess stage on a fake fastMRI ``.h5`` holding
    the k-space and the images as its ``reconstruction_esc`` target, as the
    corpus script writes it (the target outranks the k-space), against
    ``tools/make_corpus.py``'s pack of the same seed."""
    pytest.importorskip("h5py", reason="the .h5 route needs h5py")
    seed, s, h, w, out = 2026, 10, 96, 80, 64
    ksp, imgs = synthetic_kspace_volume(np.random.default_rng(seed), s=s,
                                        h=h, w=w)
    raw = tmp_path / "raw"
    raw.mkdir()
    write_fake_fastmri_h5(str(raw / "vol0000.h5"), ksp, target=imgs)
    assert jlauncher.run_preprocess(
        raw, tmp_path / "jax", out, out, "0.3,0.7", "1.0,99.5", False, False,
        6) == 1
    pre = make_corpus.corpus_preprocessor("cpu", out_size=(out, out))
    make_corpus.pack_corpus_volume(pre, seed, str(tmp_path / "port"), s, h,
                                   w)
    with np.load(tmp_path / "jax" / "vol0000" / "volume.npz") as z:
        jimg, jmsk = z["img"], z["msk"]
    with np.load(tmp_path / "port" / "volume.npz") as z:
        timg, tmsk = z["img"], z["msk"]
    assert timg.shape == jimg.shape == (4, 1, out, out)
    np.testing.assert_array_equal(tmsk, jmsk)
    assert 0 < tmsk.sum() < tmsk.size
    assert np.abs(timg - jimg).max() <= TENSOR_TOL


def test_make_corpus_resumes_and_names_packs_as_the_h5_route(tmp_path,
                                                               capsys):
    out = tmp_path / "packs"
    first = make_corpus.make_corpus(str(out), volumes=3, slices=4,
                                    height=48, width=40, device="cpu")
    # the keep band [int(4 * 0.3), int(4 * 0.7)) holds one slice
    assert first["made"] == 3 and first["slices_per_pack"] == [1, 1, 1]
    (out / "vol0003.tmp").mkdir()          # a crash mid-write
    (out / "vol0003.tmp" / "volume.npz").write_bytes(b"")
    again = make_corpus.make_corpus(str(out), volumes=4, slices=4,
                                    height=48, width=40, device="cpu")
    assert (again["made"], again["skipped"]) == (1, 3)
    assert sorted(p.name for p in out.iterdir()) == [
        "vol0000", "vol0001", "vol0002", "vol0003"]
    files = launcher.collect_npz(out)
    assert launcher.split_volumes(files, 0.8, 42) == \
        jlauncher.split_volumes(files, 0.8, 42)
    assert make_corpus.main(["--out", str(out), "--volumes", "4",
                             "--slices", "4", "--height", "48", "--width",
                             "40", "--device", "cpu"]) == 0
    assert "0 packed, 4 already there" in capsys.readouterr().out


def test_corpus_preprocessor_is_the_launchers():
    ns = launcher.build_parser().parse_args([])
    pre = make_corpus.corpus_preprocessor("cpu")
    assert pre.out_size == (ns.height, ns.width)
    assert pre.slice_keep == tuple(float(v) for v in ns.slice_keep.split(","))
    assert tuple(pre.clip_percentiles) == tuple(
        float(v) for v in ns.clip.split(","))


@pytest.mark.parametrize("bar,run", [("b8", "corpus_scale_b8"),
                                     ("b128", "corpus_scale"),
                                     ("synthetic16",
                                      "fastmri_unet_synthetic")])
def test_corpus_run_bars_are_the_committed_runs(bar, run):
    """Each bar's launcher flags give the committed JAX run's arguments,
    aside from paths, the JAX-only ``multihost`` and the b128 run's
    ``ckpt_backend`` (orbax: a JAX library the port refuses; its async
    snapshots every 30 steps, 2 kept, run in the port's own format); the
    fields an older ``args.json`` lacks take their defaults."""
    with open(REPO / "runs" / run / "args.json", encoding="utf-8") as f:
        want = json.load(f)
    flags = [*corpus_run.COMMON_FLAGS, *corpus_run.BARS[bar]["flags"]]
    parser = launcher.build_parser()
    ns = launcher.apply_preset(parser, parser.parse_args(flags), flags)
    fields = {k: getattr(ns, k) for k in launcher._FORWARDED_TRAIN_FIELDS
              if k != "ckpt_backend"}
    defaults = dataclasses.asdict(UNet2DArgs())
    assert fields == {k: want.get(k, defaults[k]) for k in fields}
    with open(REPO / "runs" / run / "summary.json", encoding="utf-8") as f:
        assert json.load(f)["best"]["val_dice"] == \
            corpus_run.BARS[bar]["jax_val_dice"]


def test_synthetic16_corpus_gives_the_jax_runs_steps():
    """The synthetic16 bar's corpus (16 volumes of 36 slices) through the
    launcher's slice band and split gives the JAX run's steps an epoch
    (``runs/fastmri_unet_synthetic/history_step.csv``): 13 train volumes
    of 15 slices, 24 batches of 8."""
    corpus = corpus_run.BARS["synthetic16"]["corpus"]
    s0, s1 = make_corpus.corpus_preprocessor("cpu")._keep_band(
        corpus["slices"])
    train, val = launcher.split_volumes(
        [f"vol{i:04d}" for i in range(corpus["volumes"])], 0.8, 2024)
    with open(REPO / "runs" / "fastmri_unet_synthetic" / "history_step.csv",
              encoding="utf-8") as f:
        epochs = [row.split(",")[1] for row in f.read().split()[1:]]
    assert (len(train), len(val), s1 - s0) == (13, 3, 15)
    assert len(train) * (s1 - s0) // 8 == epochs.count("1") == 24
