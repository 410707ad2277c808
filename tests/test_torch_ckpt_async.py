"""The port's background resume snapshots (``--ckpt-async``,
``train/checkpoint.py``: ``save_resume_async``, ``PendingSnapshot``,
``ResumeWriter``), on the CPU.

The JAX package writes them through orbax (``tests/test_midepoch_resume.py::
test_async_snapshots_publish_and_resume``); the port writes its own format
and holds the async snapshot to the blocking one, bit for bit:

1. the snapshot is the state at the call: an in-place update right after
   ``save_resume_async`` returns, as ``optimizer.step()`` makes, does not
   reach it (a writer thread that keeps the caller's tensors fails here);
2. until ``finalize()`` it is ``<dir>.tmp`` and ``latest_resume_dir``
   returns the previous snapshot; ``finalize`` publishes, prunes to
   ``keep``, and a second call does nothing; a new save finalizes the
   pending one;
3. a write error surfaces at ``finalize`` and publishes nothing; in a
   crash it is printed and the crash's exception goes on;
4. the 2-D trainer's mid-epoch async snapshots (JAX's settings: 12 train
   slices, batch 4, chunks of 2) publish JAX's names with the blocking
   run's tensors and ``host.json`` bytes; a crash in the step after one
   publishes it, and the run resumed from it equals the straight run;
5. a VarNet epoch, and ``cli.train_varnet``, leave the same files with and
   without it.
"""
import json
import os
import sys
import threading
from pathlib import Path

import pytest
import torch

from test_torch_quant import one_thread  # noqa: F401
from test_torch_resume import _args, lists  # noqa: F401
from test_torch_varnet_trainer import NARROW, _samples

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import train_varnet
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.varnet_synthetic import (
    write_dwi_h5)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint as ckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.train import varnet_trainer
from mri_acl_imagesegmentation_adsp_tpu_torch.train.trainer import (
    UNet2DTrainer)

WAIT_S = 30.0
REAL_SAVE = torch.save


def _state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"model": {"conv.weight": torch.randn(4, 3, 3, 3, generator=g),
                      "bn.running_var": torch.rand(4, generator=g),
                      "bn.num_batches_tracked": torch.tensor(7)},
            "optimizer": {"mu": [torch.randn(5, generator=g)],
                          "nu": [torch.rand(5, generator=g)], "count": 3},
            "generators": {"perm": g.get_state()}}


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else ())
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}.{k}"))
    return out


def _clone(tree):
    return {k: v.clone() for k, v in _tensors(tree).items()}


def _assert_tensors_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(
            got[k], want[k]), k


def _assert_same_snapshots(a: str, b: str) -> list:
    """The resume directories under two run directories: the same names,
    every ``state.pt`` tensor equal, every ``host.json`` byte-equal.
    Returns the names."""
    ra, rb = Path(a) / "checkpoints", Path(b) / "checkpoints"
    names = sorted(p.name for p in ra.iterdir())
    assert names == sorted(p.name for p in rb.iterdir())
    for name in names:
        ta, ha = ckpt.load_train_state(str(ra / name))
        tb, hb = ckpt.load_train_state(str(rb / name))
        _assert_tensors_equal(_tensors(ta), _tensors(tb))
        assert ha == hb
        assert (ra / name / "host.json").read_bytes() == (
            rb / name / "host.json").read_bytes()
    return names


@pytest.fixture
def gated_save(monkeypatch):
    """``torch.save`` held until the test opens the gate."""
    gate = threading.Event()

    def save(obj, path):
        assert gate.wait(WAIT_S), "the gate was never opened"
        REAL_SAVE(obj, path)
    monkeypatch.setattr(torch, "save", save)
    return gate


def test_in_place_update_after_the_call_does_not_reach_the_snapshot(
        tmp_path, gated_save):
    state, host = _state(), {"epoch_next": 2, "history": [{"val": 0.5}]}
    before = _clone(state)
    pending = ckpt.save_resume_async(str(tmp_path / "async"), 1, state, host)
    for t in _tensors(state).values():
        t.add_(1)                  # as optimizer.step() and BatchNorm do
    gated_save.set()
    pending.finalize()
    got, got_host = ckpt.load_train_state(str(
        tmp_path / "async" / "checkpoints" / "resume_000001"))
    _assert_tensors_equal(_tensors(got), before)
    assert got_host == host and got["optimizer"]["count"] == 3
    # and it is the blocking write of the same state
    state_b = _state()
    ckpt.save_resume(str(tmp_path / "blocking"), 1, state_b, host)
    _assert_same_snapshots(tmp_path / "async", tmp_path / "blocking")


def test_copies_and_writer_under_a_short_switch_interval(tmp_path):
    """Twenty save / update / finalize rounds with the interpreter
    switching threads every microsecond: each snapshot is its call's
    state."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        state = _state(1)
        writer = ckpt.ResumeWriter(str(tmp_path), keep=0, asynchronous=True)
        want = {}
        for epoch in range(20):
            want[epoch] = _clone(state)
            writer.save(epoch, state, {"epoch": epoch})
            for t in _tensors(state).values():
                t.mul_(-1).add_(epoch)
        writer.finalize()
    finally:
        sys.setswitchinterval(old)
    for epoch, tensors in want.items():
        got, host = ckpt.load_train_state(str(
            tmp_path / "checkpoints" / f"resume_{epoch:06d}"))
        _assert_tensors_equal(_tensors(got), tensors)
        assert host == {"epoch": epoch}


def test_publish_prune_and_finalize_once(tmp_path, gated_save):
    out = str(tmp_path)
    root = tmp_path / "checkpoints"
    gated_save.set()
    ckpt.save_resume(out, 0, _state(0), {"epoch": 0})
    gated_save.clear()
    pending = ckpt.save_resume_async(out, 1, _state(1), {"epoch": 1},
                                     keep=1)
    assert ckpt.latest_resume_dir(out).endswith("resume_000000")
    assert (root / "resume_000001.tmp" / "host.json").is_file()
    assert not (root / "resume_000001").exists()
    gated_save.set()
    assert pending.finalize() == str(root / "resume_000001")
    assert sorted(p.name for p in root.iterdir()) == ["resume_000001"]
    assert pending.finalize() == str(root / "resume_000001")   # nothing
    writer = ckpt.ResumeWriter(out, keep=2, asynchronous=True)
    writer.save(2, _state(2), {"epoch": 2})
    first = writer.pending
    writer.save(3, _state(3), {"epoch": 3}, step=5)   # finalizes epoch 2
    assert first._done and writer.pending is not first
    assert ckpt.latest_resume_dir(out).endswith("resume_000002")
    writer.finalize()
    assert writer.pending is None
    assert sorted(p.name for p in root.iterdir()) == [
        "resume_000002", "resume_000003_000005"]


def test_write_error_surfaces_at_finalize(tmp_path, monkeypatch, capsys):
    def fail(obj, path):
        raise OSError("no space left on device")
    monkeypatch.setattr(torch, "save", fail)
    pending = ckpt.save_resume_async(str(tmp_path), 1, _state(), {})
    with pytest.raises(OSError, match="no space"):
        pending.finalize()
    assert os.listdir(tmp_path / "checkpoints") == []
    assert ckpt.latest_resume_dir(str(tmp_path)) is None
    pending.finalize()                           # a second call: nothing
    # in a crash the failed publish is printed, the crash goes on
    writer = ckpt.ResumeWriter(str(tmp_path), asynchronous=True)
    with pytest.raises(KeyError, match="crash"):
        with writer.publishing("trainer"):
            writer.save(2, _state(), {})
            raise KeyError("crash")
    assert "finalize of the pending snapshot failed" in capsys.readouterr(
        ).out
    assert os.listdir(tmp_path / "checkpoints") == []


class _Kill(Exception):
    pass


@pytest.fixture(scope="module")
def blocking_run(lists):  # noqa: F811
    """One epoch at JAX's async-test settings, blocking snapshots."""
    t = UNet2DTrainer(_args(lists, "blocking", epochs=1, save_resume_steps=2,
                            save_resume_every=1, resume_keep=2),
                      device="cpu")
    t.run()
    return t


def test_trainer_async_snapshots_equal_the_blocking_ones(lists,  # noqa: F811
                                                         blocking_run):
    t = UNet2DTrainer(_args(lists, "async", epochs=1, save_resume_steps=2,
                            save_resume_every=1, resume_keep=2,
                            ckpt_async=True), device="cpu")
    t.run()
    assert t.snapshots.pending is None
    names = _assert_same_snapshots(t.out_dir, blocking_run.out_dir)
    assert names == ["resume_000000_000002", "resume_000001"]   # JAX's
    best = [ckpt.load_best(str(r.best_ckpt_path)) for r in (t, blocking_run)]
    _assert_tensors_equal(best[0], best[1])


def test_crash_after_an_async_snapshot_publishes_it_and_resumes(
        lists, blocking_run):  # noqa: F811
    """The step after the mid-epoch async snapshot raises: the snapshot is
    published before the exception goes on, and a run resumed from it
    equals the straight run bit for bit."""
    kw = dict(epochs=1, save_resume_steps=2, save_resume_every=1,
              resume_keep=2, ckpt_async=True)
    t = UNet2DTrainer(_args(lists, "crash", **kw), device="cpu")
    real, calls = t.engine.train_steps, []

    def crashing(store, perm, gen):
        calls.append(len(perm))
        if len(calls) == 2:
            raise _Kill("the step after the snapshot")
        return real(store, perm, gen)
    t.engine.train_steps = crashing
    with pytest.raises(_Kill):
        t.run()
    root = Path(t.out_dir) / "checkpoints"
    assert sorted(p.name for p in root.iterdir()) == ["resume_000000_000002"]
    resumed = UNet2DTrainer(_args(lists, "crash", resume=True, **kw),
                            device="cpu")
    resumed.run()
    names = _assert_same_snapshots(resumed.out_dir, blocking_run.out_dir)
    assert names == ["resume_000000_000002", "resume_000001"]
    for name in ("history.json", "summary.json"):
        a = json.loads((Path(resumed.out_dir) / name).read_text())
        b = json.loads((Path(blocking_run.out_dir) / name).read_text())
        if name == "summary.json":
            a.pop("best_ckpt"), b.pop("best_ckpt")
        assert a == b, name
    _assert_tensors_equal(ckpt.load_best(str(resumed.best_ckpt_path)),
                          ckpt.load_best(str(blocking_run.best_ckpt_path)))


def test_varnet_epoch_async_leaves_the_blocking_files(tmp_path):
    runs = {}
    for name, on in (("blocking", False), ("async", True)):
        tr = varnet_trainer.VarNetTrainer(varnet_trainer.VarNetArgs(
            out_dir=str(tmp_path / name), ckpt_async=on, resume_keep=1,
            **{**NARROW, "epochs": 2}), _samples(3, 7), _samples(2, 8),
            device="cpu")
        tr.fit(save_resume_every=1)
        assert tr.snapshots.pending is None
        runs[name] = tr
    assert _assert_same_snapshots(tmp_path / "blocking",
                                  tmp_path / "async") == ["resume_000002"]
    _assert_tensors_equal(*(ckpt.load_best(r.best_path)
                            for r in runs.values()))


def test_cli_train_varnet_async_leaves_the_blocking_files(tmp_path):
    pytest.importorskip("h5py")
    data = tmp_path / "dwi"
    for split in ("train", "val"):
        (data / split).mkdir(parents=True)
        write_dwi_h5(str(data / split / "case0.h5"), 1, slices=2)
    flags = ["--data-path", str(data), "--epochs", "1", "--num-cascades",
             "1", "--chans", "4", "--pools", "2", "--sens-chans", "4",
             "--sens-pools", "2", "--no-amp", "--device", "cpu"]
    for name, extra in (("blocking", []), ("async", ["--ckpt-async"])):
        assert train_varnet.main(flags + ["--out-dir", str(tmp_path / name),
                                          *extra]) == 0
    assert _assert_same_snapshots(tmp_path / "blocking",
                                  tmp_path / "async") == ["resume_000001"]
