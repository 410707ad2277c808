"""The port's runs of the JAX package's committed quality references
(``tools/real_panels.py``, ``tools/unet3d_synthetic.py``), on the CPU.

The tools run whole on the card; here their constants are held to the
committed JAX runs they repeat (``runs/fastmri_unet_realdata/``,
``runs/unet3d_synthetic/``: the chip copy leaves ``runs/`` out, so the
tools carry the settings and numbers), and the real panels' mask gate runs
on the six panels through the plain versions of the mask kernels.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from mri_acl_imagesegmentation_adsp_tpu_torch.tools import (
    real_panels, unet3d_synthetic)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import trainer3d
from mri_acl_imagesegmentation_adsp_tpu_torch.train.trainer import (
    UNet2DArgs)

RUNS = Path(__file__).resolve().parents[1] / "runs"
PATHS = ("train_list", "val_list", "out_dir")


def _without_paths(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in PATHS}


def test_real_panels_settings_are_the_committed_run():
    """``JAX_ARGS`` give ``args.json`` (fields it lacks at their
    defaults); the JAX number is its ``summary.json``'s best."""
    run = RUNS / "fastmri_unet_realdata"
    want = _without_paths(json.loads((run / "args.json").read_text()))
    got = _without_paths(dataclasses.asdict(UNet2DArgs(
        **real_panels.JAX_ARGS)))
    defaults = dataclasses.asdict(UNet2DArgs())
    assert got == {k: want.get(k, defaults[k]) for k in got}
    summary = json.loads((run / "summary.json").read_text())
    assert summary["best"]["val_dice"] == real_panels.JAX_VAL_DICE
    assert summary["best"]["epoch"] == real_panels.JAX_ARGS["epochs"]
    assert real_panels.PANELS.is_file()


@pytest.fixture(scope="module")
def panels():
    return real_panels.panel_packs("cpu")


def test_real_panels_mask_gate_on_the_six_panels(panels):
    """Every panel's body mask, through the mask kernels' plain versions,
    reaches the gate against the committed mask; the packs hold z-scored
    slices that are finite."""
    tensor, masks, dice = panels
    assert tensor.shape == (6, 1, 320, 320) and masks.shape == (6, 320, 320)
    assert min(dice) >= real_panels.MASK_DICE_MIN, dice
    assert np.isfinite(tensor).all()


def test_real_panels_gate_stops_before_training(tmp_path):
    """Panels whose committed masks are cut in half fail the gate: the
    tool raises and trains nothing."""
    with np.load(real_panels.PANELS) as z:
        inputs, gts = z["inputs"], z["gt_masks"].copy()
    gts[:, :, 160:] = False
    bad = tmp_path / "panels.npz"
    np.savez(bad, inputs=inputs, gt_masks=gts)
    with pytest.raises(RuntimeError, match="mask gate"):
        real_panels.run(str(tmp_path / "work"), "cpu", panels=bad)
    assert not (tmp_path / "work").exists()


def test_unet3d_settings_are_the_committed_run():
    """``JAX_FLAGS`` through the port's trainer3d parser give
    ``best3d.ckpt.args.json`` (fields it lacks at their defaults);
    ``JAX_VAL_LOSS`` is its ``train_log.csv``; the corpus is the one its
    README names."""
    run = RUNS / "unet3d_synthetic"
    want = _without_paths(json.loads(
        (run / "best3d.ckpt.args.json").read_text()))
    got = _without_paths(dataclasses.asdict(trainer3d.parse_args([
        "--train-list", "t", "--val-list", "v",
        *unet3d_synthetic.JAX_FLAGS])))
    got = {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()}
    defaults = dataclasses.asdict(trainer3d.UNet3DArgs())
    assert got == {k: want.get(k, defaults[k]) for k in got}
    log = unet3d_synthetic.read_log(str(run / "train_log.csv"))
    assert log["val_loss"] == unet3d_synthetic.JAX_VAL_LOSS
    c = unet3d_synthetic.CORPUS
    assert (f"{c['volumes']} synthetic {c['height']}x{c['width']} volumes "
            f"({c['slices']} slices each") in " ".join(
                (run / "README.md").read_text().split())
    assert unet3d_synthetic.LOSS_FACTOR * min(log["val_loss"]) == \
        pytest.approx(0.0666, abs=1e-4)
