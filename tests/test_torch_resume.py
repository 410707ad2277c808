"""Resume snapshots, preemption, chunked epochs, TensorBoard and profiling
of the PyTorch port's trainer (``train/checkpoint.py``,
``train/trainer.py``, ``train/loggers.py``), on the CPU.

The invariants are the JAX package's (``tests/test_midepoch_resume.py``,
``tests/test_checkpoint.py``), each bit for bit, no tolerance:

1. an epoch run in chunks of ``save_resume_steps`` steps equals the
   whole-epoch dispatch: parameters, BatchNorm statistics, optimizer
   moments and count, history;
2. a run killed right after a mid-epoch snapshot and resumed in a fresh
   trainer equals the uninterrupted run, its ``best.ckpt`` included, and
   the resumed epoch takes only the rows not yet taken;
3. ``request_preempt()`` (and SIGUSR1 under ``--preempt-save``) snapshots
   at the next chunk end, stops cleanly and resumes to the same result;
4. ``--resume-keep`` prunes the oldest snapshots; snapshots load with
   ``weights_only=True`` and a pickled object in one is refused.
"""
import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_quant import one_thread  # noqa: F401

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint as ckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.train.loggers import (
    MultiLogger, TensorBoardLogger, make_logger)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.trainer import (
    UNet2DArgs, UNet2DTrainer)

HW = 32


def _blobs(rng, n):
    """``n`` noisy disc images and their masks, (n, 1, HW, HW)."""
    yy, xx = np.mgrid[:HW, :HW]
    cy, cx = rng.integers(8, HW - 8, (2, n))
    r = rng.integers(4, 9, n)
    m = ((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2
         < (r * r)[:, None, None])
    img = m + 0.15 * rng.standard_normal((n, HW, HW))
    return img[:, None].astype(np.float32), m.astype(np.uint8)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Three packed volumes of six blob slices: two to train on (12
    slices, 3 steps of 4), one to validate on."""
    root = tmp_path_factory.mktemp("resume")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(3):
        x, y = _blobs(rng, 6)
        d = root / "art" / f"vol{i}"
        d.mkdir(parents=True)
        np.savez(d / "volume.npz", img=x, msk=y)
        paths.append(str(d / "volume.npz"))
    (root / "train.txt").write_text("\n".join(paths[:2]))
    (root / "val.txt").write_text(paths[2])
    return root, str(root / "train.txt"), str(root / "val.txt")


def _args(lists, name, **kw):
    root, train, val = lists
    fields = dict(train_list=train, val_list=val, out_dir=str(root / name),
                  encoder="resnet18", batch_size=4, epochs=2, workers=0,
                  amp=False, seed=321, logger="csv")
    fields.update(kw)
    return UNet2DArgs(**fields)


def _state(t: UNet2DTrainer) -> dict:
    out = {f"model.{k}": v.detach().clone()
           for k, v in t.model.state_dict().items()}
    opt = t.optimizer.state_dict()
    for i, (m, v) in enumerate(zip(opt["mu"], opt["nu"])):
        out[f"mu.{i}"], out[f"nu.{i}"] = m.clone(), v.clone()
    out["count"] = torch.tensor(opt["count"])
    return out


def _assert_same(a: UNet2DTrainer, b: UNet2DTrainer):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.history == b.history
    ha = json.loads((Path(a.out_dir) / "history.json").read_text())
    hb = json.loads((Path(b.out_dir) / "history.json").read_text())
    assert ha == hb
    best_a = ckpt.load_best(str(a.best_ckpt_path))
    best_b = ckpt.load_best(str(b.best_ckpt_path))
    assert best_a.keys() == best_b.keys()
    for k in best_a:
        assert torch.equal(best_a[k], best_b[k]), k


@pytest.fixture(scope="module")
def straight(lists):
    t = UNet2DTrainer(_args(lists, "straight"), device="cpu")
    t.run()
    return t


class _Kill(Exception):
    pass


def test_chunked_epoch_equals_whole_epoch(lists, straight):
    t = UNet2DTrainer(_args(lists, "chunked", save_resume_steps=2),
                      device="cpu")
    t.run()
    _assert_same(straight, t)
    snaps = sorted(os.listdir(Path(t.out_dir) / "checkpoints"))
    assert snaps == ["resume_000000_000002", "resume_000001_000002"]


def test_kill_after_chunk_then_resume_bitwise(lists, straight):
    """Killed right after epoch 2's first mid-epoch snapshot (1 epoch and 1
    step done), resumed in a fresh trainer: the uninterrupted run."""
    args = _args(lists, "killed", save_resume_steps=1)
    t = UNet2DTrainer(args, device="cpu")
    real = t._save_mid_resume

    def killing(ep, steps_done, perm, losses):
        real(ep, steps_done, perm, losses)
        if ep == 2:
            raise _Kill()
    t._save_mid_resume = killing
    with pytest.raises(_Kill):
        t.run()
    latest = ckpt.latest_resume_dir(args.out_dir)
    assert Path(latest).name == "resume_000001_000001"

    r = UNet2DTrainer(_args(lists, "killed", save_resume_steps=1,
                            resume=True), device="cpu")
    assert r.start_epoch == 2 and r._mid_resume["steps_done"] == 1
    seen = []
    real_steps = r.engine.train_steps

    def spy(store, perm, gen):
        seen.append(int(perm.shape[0]))
        return real_steps(store, perm, gen)
    r.engine.train_steps = spy
    r.run()
    assert seen == [1, 1]            # 3 steps in the epoch, 1 already taken
    _assert_same(straight, r)
    rows = (Path(args.out_dir) / "history_step.csv").read_text().split()
    assert len(rows) == 1 + 6        # header + every step logged once


def test_preempt_request_snapshots_and_resumes_bitwise(lists, straight):
    args = _args(lists, "preempted", save_resume_steps=2)
    t = UNet2DTrainer(args, device="cpu")
    real_steps = t.engine.train_steps

    def preempting(store, perm, gen):
        out = real_steps(store, perm, gen)
        t.request_preempt()          # during epoch 1's first chunk
        return out
    t.engine.train_steps = preempting
    out = t.run()
    assert out["summary"]["preempted"] is True and out["history"] == []
    assert Path(ckpt.latest_resume_dir(args.out_dir)).name == (
        "resume_000000_000002")
    r = UNet2DTrainer(_args(lists, "preempted", save_resume_steps=2,
                            resume=True), device="cpu")
    r.run()
    _assert_same(straight, r)
    assert "preempted" not in json.loads(
        (Path(args.out_dir) / "summary.json").read_text())


def test_preempt_signal_at_epoch_end_resumes_bitwise(lists, straight):
    """``--preempt-save``: SIGUSR1 during epoch 1 (no chunks) snapshots at
    the epoch's end and stops; the handlers are put back after the run."""
    args = _args(lists, "signalled", preempt_save=True)
    t = UNet2DTrainer(args, device="cpu")
    real_steps = t.engine.train_steps

    def signalling(store, perm, gen):
        os.kill(os.getpid(), signal.SIGUSR1)
        return real_steps(store, perm, gen)
    t.engine.train_steps = signalling
    before = signal.getsignal(signal.SIGUSR1)
    out = t.run()
    assert signal.getsignal(signal.SIGUSR1) is before
    assert out["summary"]["preempted"] is True
    assert [h["epoch"] for h in out["history"]] == [1]
    assert Path(ckpt.latest_resume_dir(args.out_dir)).name == "resume_000001"
    r = UNet2DTrainer(_args(lists, "signalled", resume=True), device="cpu")
    assert r.start_epoch == 2
    r.run()
    _assert_same(straight, r)


def test_resume_keep_prunes_oldest(tmp_path):
    """keep=N leaves the newest N complete snapshots (a mid-epoch one sorts
    between its epoch ends), sweeps a stale *.tmp and spares a fresh one;
    keep=0 keeps all."""
    out = str(tmp_path / "run")
    tensors = {"w": torch.arange(4.0)}
    for ep in range(3):
        ckpt.save_resume(out, ep, tensors, {"epoch": ep})
    root = Path(out) / "checkpoints"
    assert len(os.listdir(root)) == 3
    stale = root / "resume_000099.tmp"
    stale.mkdir()
    os.utime(stale, (0, 0))
    (root / "resume_000098.tmp").mkdir()
    ckpt.save_resume(out, 3, tensors, {"epoch": 3}, keep=2)
    ckpt.save_resume(out, 3, tensors, {"epoch": 3, "mid": True}, step=40,
                     keep=2)
    assert sorted(os.listdir(root)) == [
        "resume_000003", "resume_000003_000040", "resume_000098.tmp"]
    latest = ckpt.latest_resume_dir(out)
    assert latest.endswith("resume_000003_000040")
    got, host = ckpt.load_train_state(latest)
    assert host == {"epoch": 3, "mid": True}
    assert torch.equal(got["w"], tensors["w"])


def test_trainer_resume_keep(lists):
    args = _args(lists, "kept", save_resume_steps=1, save_resume_every=1,
                 resume_keep=2)
    UNet2DTrainer(args, device="cpu").run()
    assert sorted(os.listdir(Path(args.out_dir) / "checkpoints")) == [
        "resume_000001_000002", "resume_000002"]


def test_snapshots_load_weights_only(tmp_path):
    d = str(tmp_path / "snap")
    ckpt.save_train_state(d, {"model": {"w": torch.ones(2)},
                              "optimizer": {"mu": [torch.zeros(2)],
                                            "count": 3},
                              "generators": {"aug": torch.Generator(
                                  ).get_state()}}, {"epoch_next": 2})
    tensors, host = ckpt.load_train_state(d)
    assert tensors["optimizer"]["count"] == 3 and host["epoch_next"] == 2
    torch.save({"model": torch.nn.Linear(2, 2)}, os.path.join(d, "state.pt"))
    with pytest.raises(Exception, match="[Ww]eights only"):
        ckpt.load_train_state(d)


def test_refuses_what_is_not_ported(lists):
    for kw in ({"ckpt_backend": "orbax"}, {"ckpt_async": True},
               {"store_sharded": True}, {"save_resume_steps": -1}):
        flag = "--" + next(iter(kw)).replace("_", "-")
        with pytest.raises(ValueError, match=flag):
            UNet2DTrainer(_args(lists, "refused", **kw), device="cpu")


def test_launcher_csv_tb_and_profile(lists, tmp_path):
    """``--logger csv+tb`` writes the CSV files and event files under
    ``<out>/tb``; ``--profile-epochs 1`` leaves a trace of epoch 1 only."""
    root, train, val = lists
    out = tmp_path / "run"
    assert launcher.main([
        "--skip-preprocess", "--skip-split", "--train-list", train,
        "--val-list", val, "--out-dir", str(out), "--epochs", "2",
        "--batch-size", "4", "--encoder", "resnet18", "--no-amp",
        "--workers", "0", "--device", "cpu", "--logger", "csv+tb",
        "--profile-epochs", "1"]) == 0
    assert (out / "history_epoch.csv").is_file()
    events = list((out / "tb").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0
    traces = sorted(p.name for p in (out / "profile").iterdir())
    assert traces == ["epoch_001.pt.trace.json"]
    trace = json.loads((out / "profile" / traces[0]).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    assert isinstance(make_logger("tb", str(tmp_path / "tb_only")),
                      TensorBoardLogger)
    assert isinstance(make_logger("csv,tb", str(tmp_path / "both")),
                      MultiLogger)
