"""Data parallelism, part 3: the trainers and entry points on two gloo CPU
ranks against one process: the launcher's ``--data-parallel 2
--store-sharded`` run (its run directory is the one-rank run's, written by
rank 0), one step of the classifier and of the 3-D trainer, and
``graft_entry.dryrun_multichip(2, device="cpu")``.

Tolerances, each stated where it is checked:
- the launcher: the same files in the run directory, the same step count,
  the first step's loss within 1e-5 relative (f32), every loss finite;
- the classifier (tiny ConvNeXt, f32, SGD at lr 1e-2 so that the
  parameters move by lr times the gradient): the loss within 1e-6
  relative, the logits gathered from the ranks and the parameters after
  the step within 1e-5 of each tensor's max, the validation loss within
  1e-6 relative;
- the 3-D trainer (channels (4, 8), ROI 16x16x8, f32): the loss within
  1e-6 relative and every gradient within 1e-4 of its tensor's max plus
  1e-6 of the largest gradient (f32 sums over 2 x 2048 voxels reassociate;
  a conv bias before an InstanceNorm has a zero gradient, rounding noise
  on both sides);
- the dry run: its own gates (the JAX tolerances: train loss 1e-4,
  validation loss 5e-4, classifier losses 1e-4).
"""
import csv
import json

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from mri_acl_imagesegmentation_adsp_tpu_torch import graft_entry
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs, put back after it (its
    rank processes run one each): the tier-1 run shares the machine's
    cores among several workers, and idle threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + 1e-30, (name, err)


def _packs3d(root):
    rng = np.random.default_rng(0)
    files = []
    for v, s in enumerate((12, 12)):
        img = rng.standard_normal((s, 1, 24, 24)).astype(np.float32)
        msk = np.zeros((s, 24, 24), np.uint8)
        msk[s // 3:s // 3 + 4, 8:16, 8:16] = 1
        d = root / f"v{v}"
        d.mkdir(parents=True)
        np.savez_compressed(d / "volume.npz", img=img, msk=msk)
        files.append(str(d / "volume.npz"))
    lst = root / "list.txt"
    lst.write_text("\n".join(files))
    return str(lst)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    lst = _packs3d(root / "packs")
    two = mesh.spawn(ranks.trainers_rank, 2, ["cpu", "cpu"], threads=1,
                     args=(lst, str(root / "dp")), timeout_s=600)
    one = {"classifier": ranks.classifier_step(),
           "trainer3d": ranks.trainer3d_step(lst, str(root / "one"))}
    return one, two


def test_classifier_step_on_two_ranks(steps):
    one, two = steps
    want = {k: v.numpy() if hasattr(v, "numpy") else v
            for k, v in one["classifier"].items()}
    for got in two:
        got = got["classifier"]
        _close(got["loss"], want["loss"], 1e-6, "loss")
        _close(got["val_loss"], want["val_loss"], 1e-6, "val_loss")
        _close(got["logits"], want["logits"], 1e-5, "logits")
        _close(got["val_logits"], want["val_logits"], 1e-5, "val_logits")
        for n, w in want["params"].items():
            _close(got["params"][n], w.numpy(), 1e-5, n)


def test_trainer3d_step_on_two_ranks(steps):
    one, two = steps
    want = {k: v.numpy() for k, v in one["trainer3d"].items()}
    top = max(np.abs(w).max() for n, w in want.items() if n != "loss")
    for got in two:
        got = got["trainer3d"]
        _close(got["loss"], want["loss"], 1e-6, "loss")
        for n, w in want.items():
            err = np.abs(got[n] - w).max()
            assert err <= 1e-4 * np.abs(w).max() + 1e-6 * top, (n, err)


def _launch(root, out, *extra):
    return launcher.main([
        "--skip-preprocess", "--artifact-dir", str(root / "art"),
        "--list-dir", str(root / "lists"), "--out-dir", str(out),
        "--epochs", "1", "--batch-size", "4", "--encoder", "resnet18",
        "--no-amp", "--device", "cpu", *extra])


def _step_losses(run):
    with open(run / "history_step.csv", newline="") as f:
        return [float(r["train_loss_step"]) for r in csv.DictReader(f)]


def test_launcher_data_parallel_writes_the_one_rank_run(tmp_path):
    pre = MRIKneePreprocessor(out_size=(32, 32), device="cpu")
    for i in range(4):
        pack_kspace_volume(pre, synthetic_kspace_pairs(seed=i, s=10, h=64,
                                                       w=48),
                           str(tmp_path / "art" / f"vol{i}"))
    assert _launch(tmp_path, tmp_path / "one") == 0
    assert _launch(tmp_path, tmp_path / "two", "--skip-split",
                   "--data-parallel", "2", "--store-sharded") == 0
    one, two = tmp_path / "one", tmp_path / "two"
    files = lambda d: sorted(str(p.relative_to(d))  # noqa: E731
                             for p in d.rglob("*"))
    assert files(two) == files(one)
    args = json.loads((two / "args.json").read_text())
    assert args["data_parallel"] == 2 and args["store_sharded"]
    a, b = _step_losses(one), _step_losses(two)
    assert len(a) == len(b) > 0 and np.isfinite(b).all()
    assert abs(b[0] - a[0]) <= 1e-5 * abs(a[0]), (a, b)
    hist = json.loads((two / "history.json").read_text())
    assert len(hist) == 1 and np.isfinite(hist[0]["val_dice"])


def test_launcher_data_parallel_async_snapshots(tmp_path):
    """``--ckpt-async`` on 2 ranks: rank 0 alone writes, every rank's
    publish ends with the barrier, and the snapshots are the one-rank
    async run's names, each complete."""
    pre = MRIKneePreprocessor(out_size=(32, 32), device="cpu")
    for i in range(4):
        pack_kspace_volume(pre, synthetic_kspace_pairs(seed=i, s=10, h=64,
                                                       w=48),
                           str(tmp_path / "art" / f"vol{i}"))
    flags = ("--save-resume-steps", "2", "--save-resume-every", "1",
             "--resume-keep", "2", "--ckpt-async")
    assert _launch(tmp_path, tmp_path / "one", *flags) == 0
    assert _launch(tmp_path, tmp_path / "two", "--skip-split",
                   "--data-parallel", "2", *flags) == 0
    names = [sorted(p.name for p in (tmp_path / d / "checkpoints").iterdir())
             for d in ("one", "two")]
    assert names[0] == names[1] == ["resume_000000_000002", "resume_000001"]
    assert checkpoint.latest_resume_dir(str(tmp_path / "two")).endswith(
        "resume_000001")
    for name in names[1]:
        d = tmp_path / "two" / "checkpoints" / name
        assert (d / "state.pt").is_file() and (d / "host.json").is_file()


def test_launcher_refuses_more_ranks_than_cards(tmp_path):
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        launcher.run_training(tmp_path / "t.txt", tmp_path / "v.txt",
                              tmp_path / "run",
                              launcher.build_parser().parse_args(
                                  ["--data-parallel", "2"]))


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """Every part of JAX's dry run ran, each held to one device."""
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert out["ran"] == ["unet_dp_sharded_store", "classifier_dp",
                          "varnet_tp", "t2_sharded_recon", "varnet_pp",
                          "unet3d_spatial"]
    assert graft_entry.NOT_PORTED == () and out["not_ported"] == []
    tp = out["one_device"]["varnet_tp"]
    assert tp["max_grad_drift"] < graft_entry.VARNET_DRIFT_TOL
    assert out["one_device"]["t2_sharded_recon"]["max_abs_diff"] <= (
        graft_entry.T2_TOL)
    pp = out["one_device"]["varnet_pp"]
    assert pp["max_grad_drift"] < graft_entry.VARNET_DRIFT_TOL
    assert abs(out["ranks"]["varnet_pp"]["loss"] - pp["loss"]) < (
        graft_entry.PP_LOSS_TOL)
    assert abs(out["ranks"]["unet3d_spatial"] - out["one_device"][
        "unet3d_spatial"]["train_loss"]) < graft_entry.SPATIAL_TOL
    assert out["backend"] == "gloo" and out["where"] == "2 CPU ranks"
    said = capsys.readouterr().out
    assert "sharded == replicated" in said and "not ported" not in said
    assert "dryrun_varnet_tp(1x2 data x coil)" in said
    assert "dryrun_varnet_pp(2-stage pipe" in said
    assert "dryrun_unet3d_spatial(2-way depth axis)" in said
    json.dumps(out)                 # chip_smoke.py prints it as one line
