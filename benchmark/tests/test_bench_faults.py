"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size, with one fault planted in the port: a step
that leaves the state unchanged; half of each batch left out, the mean
taken over the rest; an answer altered where it is produced; half of a
volume's slices left out of the model (answered as background). The
cell's own limits judge it.
"""

import pytest
import torch

from benchmark import harness
from benchmark.reference.compare import held
from benchmark.run import result_line, run_cell

SEED = 2 ** 31 + 19


def _train_cell():
    cell = harness.cell("train.unet_r34.b128")
    cell["config"]["image_size"] = 64
    cell["traffic"].update(volumes=2, slices_per_volume=16, batch=8)
    return cell


def _kspace_cell():
    cell = harness.cell("kspace.unet_r34.c4")
    cell["config"]["image_size"] = 64
    cell["traffic"].update(slices=[4, 6], volumes_per_size=1,
                           kspace_hw=[160, 96], checked_answers=3, clients=2)
    return cell


def _run(cell):
    res = run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0)
    return res, result_line(cell, res, False, "cpu")


def _unchanged(monkeypatch):
    from mri_acl_imagesegmentation_adsp_tpu_torch.train import optim

    def step(self, grads):
        self.count += 1
    monkeypatch.setattr(optim.ClippedAdamW, "step", step)


def _half_batch(monkeypatch):
    from mri_acl_imagesegmentation_adsp_tpu_torch.train import engine
    gather = engine.gather_batch
    monkeypatch.setattr(engine, "gather_batch",
                        lambda store, idx: gather(store, idx[:len(idx) // 2]))


def _altered_answer(monkeypatch):
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
    threshold = serve.threshold_probs

    def altered(probs, classes, thr):
        out = threshold(probs, classes, thr)
        out[0, :16, :16] ^= 1
        return out
    monkeypatch.setattr(serve, "threshold_probs", altered)


def _half_slices(monkeypatch):
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
    segment = serve.segment_volume_2d

    def half(apply_fn, volume, **kw):
        keep = max(1, volume.shape[0] // 2)
        probs = segment(apply_fn, volume[:keep], **kw)
        return torch.cat([probs, probs.new_zeros(
            (volume.shape[0] - keep,) + probs.shape[1:])])
    monkeypatch.setattr(serve, "segment_volume_2d", half)


@pytest.mark.parametrize("cell,fault", [
    (_train_cell, _unchanged), (_train_cell, _half_batch),
    (_kspace_cell, _altered_answer), (_kspace_cell, _half_slices)],
    ids=["train-state-unchanged", "train-half-batch",
         "kspace-answer-altered", "kspace-half-slices"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    c = cell()
    sound, sound_line = _run(c)
    with monkeypatch.context() as m:
        fault(m)
        res, line = _run(c)
    assert line["correct"] is False
    assert not held(res["readings"], c["limits"])
    # the fault, not the small size, trips it: some compared number reads
    # above its limit and above the sound run's
    assert any(res["readings"][k] > max(c["limits"][k],
                                        sound["readings"][k])
               for k in c["limits"])
