"""Parity of the PyTorch port's evaluation and 2-D inference with the JAX
package: ``evaluate_volume``, ``tta_wrap``, ``segment_volume_2d(tta=)``,
the batch inference CLI end to end, ``UNet2DTrainer.test`` and the run
report.

Tolerances, each stated where it is checked:
- ``evaluate_volume`` (S = 11, not a multiple of the 8-slice chunk): Dice
  and IoU within 1e-6, HD95 and ASSD within 1e-5, relative;
- ``tta_wrap`` probabilities within 1e-6 (one class and three);
- probabilities through a converted model within 1e-5;
- the CLI: ``pred_mask.npy`` equal except where the JAX probability lies
  within 1e-5 of the threshold, ``summary.json`` metrics within 1e-5
  relative;
- ``UNet2DTrainer.test``: Dice and IoU within 1e-5;
- the report: ``report.html`` and ``report_metrics.json`` byte-equal;
- an ``amp`` checkpoint (bf16), against the JAX model in bf16 (plain
  decoder, run op by op, so that every op rounds to bf16): logits within
  B = 8 bf16 spacings at the largest |logit| (2^-5 of its binade), every
  one a bf16 number and at least a quarter bit-equal to JAX's, their mean
  distance to JAX's below 3/4 of the f32 path's, and masks equal wherever
  the JAX |logit| exceeds B. The f32 path (the port before bf16 serving)
  has no logit equal to JAX's;
- ``--quant`` / ``--qtree``: the CLI's probabilities equal its engine's
  in-process ones exactly; against the JAX CLI on one artifact within
  1e-2 (the JAX CLI runs the engine jitted, where XLA fuses the dequant's
  multiply and add), masks equal except within 1e-2 of the threshold.
"""
import json
from contextlib import nullcontext
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import NARROW, jax_variables
from test_torch_quant import (JAX_CLS, flax_variables, nchw, nhwc,
                              one_thread, train_port_model)  # noqa: F401

from mri_acl_imagesegmentation_adsp_tpu.cli import infer as jax_infer
from mri_acl_imagesegmentation_adsp_tpu.infer import segment as jseg
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.report import exporter as jexporter
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jax_ckpt
from mri_acl_imagesegmentation_adsp_tpu.train import trainer as jtrainer
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer, quantize
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer import segment
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import init_weights
from mri_acl_imagesegmentation_adsp_tpu_torch.report import exporter
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    checkpoint, trainer)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.quant import (
    QuantConfig, QuantizedUNet2D)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.device import f32_on_card
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.imagenet import (
    make_input_norm)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.png import write_png
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

ARGS = {"model": "unet", "encoder": "resnet18", "k": 1, "classes": 1,
        "amp": False, "imagenet_norm": False}


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _volume_masks(s=11, h=48, w=40):
    """(pred, gt) uint8 stacks: shifted and resized blobs, one slice with an
    empty prediction, one with both masks empty."""
    rng = np.random.default_rng(4)
    gt = np.stack([_blob(h, w, 24 + i % 3, 20, 8 + i % 5) for i in range(s)])
    pred = np.stack([_blob(h, w, 24 + dy, 20 + dx, 8 + i % 4)
                     for i, (dy, dx) in enumerate(
                         rng.integers(-3, 4, size=(s, 2)))])
    pred = pred | (rng.random((s, h, w)) > 0.995)
    pred[3] = False
    pred[7] = gt[7] = False
    return pred.astype(np.uint8), gt.astype(np.uint8)


def test_evaluate_volume_matches_jax():
    pred, gt = _volume_masks()
    want = jseg.evaluate_volume(pred, gt)
    got = segment.evaluate_volume(torch.from_numpy(pred),
                                  torch.from_numpy(gt))
    assert got.keys() == want.keys() == {"dice", "iou", "hd95", "assd"}
    for key, tol in (("dice", 1e-6), ("iou", 1e-6), ("hd95", 1e-5),
                     ("assd", 1e-5)):
        assert _rel(got[key], want[key]) <= tol, (key, got[key], want[key])
    per = segment.slice_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    assert per.shape == (11, 4) and per.dtype == torch.float32
    no_surf = segment.evaluate_volume(torch.from_numpy(pred),
                                      torch.from_numpy(gt),
                                      with_surface=False)
    assert no_surf == pytest.approx({"dice": got["dice"], "iou": got["iou"]},
                                    rel=1e-6)
    one = segment.evaluate_volume(torch.from_numpy(pred[0]),
                                  torch.from_numpy(gt[0]))
    assert one == pytest.approx(jseg.evaluate_volume(pred[0], gt[0]),
                                rel=1e-5)


def _ramp_fns(classes):
    """An apply_fn that is not mirror-symmetric, in both layouts: channel c
    is (c + 1) * x + c * ramp, where the ramp runs along W (and a smaller
    one along H, so a flip along H gives another answer)."""
    h, w = 12, 16
    ramp = (np.linspace(-3, 2, w)[None, :]
            + 0.25 * np.linspace(0, 1, h)[:, None]).astype(np.float32)
    scale = np.arange(1, classes + 1, dtype=np.float32)
    shift = np.arange(classes, dtype=np.float32)

    def jfn(x):                                           # NHWC
        return (x[..., :1] * scale + ramp[None, :, :, None] * shift)

    tr = torch.from_numpy(ramp)

    def tfn(x):                                           # NCHW
        return (x[:, :1] * torch.from_numpy(scale)[None, :, None, None]
                + tr[None, None] * torch.from_numpy(shift)[None, :, None,
                                                           None])
    x = np.random.default_rng(2).standard_normal((3, h, w, 1)).astype(
        np.float32)
    return jfn, tfn, x


@pytest.mark.parametrize("classes", [1, 3])
def test_tta_wrap_matches_jax(classes):
    jfn, tfn, x = _ramp_fns(classes)
    jout = np.asarray(jseg.tta_wrap(jfn, classes, "hflip")(jnp.asarray(x)))
    tout = segment.tta_wrap(tfn, classes, "hflip")(
        torch.from_numpy(x.transpose(0, 3, 1, 2)))
    if classes == 1:
        want = 1 / (1 + np.exp(-jout.astype(np.float64)))
        got = torch.sigmoid(tout).numpy()
    else:
        want = np.asarray(jax.nn.softmax(jnp.asarray(jout), axis=-1))
        got = torch.softmax(tout, dim=1).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6)
    # a flip along H instead of W would miss by far more
    wrong = segment.tta_wrap(lambda t: tfn(t.flip(2)).flip(2), classes,
                             "hflip")(torch.from_numpy(
                                 x.transpose(0, 3, 1, 2)[:, :, ::-1].copy()))
    assert not torch.allclose(wrong, tout, atol=1e-3)
    assert segment.tta_wrap(tfn, classes, "none") is tfn
    with pytest.raises(ValueError):
        segment.tta_wrap(tfn, classes, "vflip")


@pytest.mark.parametrize("classes", [1, 3])
def test_segment_volume_2d_with_tta_matches_jax(rng, classes):
    jm = jax_build("unet", "resnet18", "none", classes=classes,
                   decoder_channels=NARROW)
    v = jax_variables(jm, 32)
    vol = rng.standard_normal((5, 32, 32)).astype(np.float32)
    want = np.asarray(jseg.segment_volume_2d(
        lambda x: jm.apply(v, x, train=False), vol, batch_size=2,
        classes=classes, tta="hflip"))
    tm = build_unet("unet", "resnet18", classes=classes,
                    decoder_channels=NARROW)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    got = segment.segment_volume_2d(tm.eval(), torch.from_numpy(vol),
                                    batch_size=2, classes=classes,
                                    tta="hflip")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = segment.segment_volume_2d(tm, torch.from_numpy(vol),
                                      batch_size=2, classes=classes)
    assert not torch.allclose(plain, got, atol=1e-4)


def _write_packs(root: Path, n=2, s=6, hw=64):
    """``n`` packed volumes from seeded synthetic k-space, every slice kept,
    and the list file naming them."""
    pre = MRIKneePreprocessor(out_size=(hw, hw), slice_keep=(0.0, 1.0),
                              device="cpu")
    paths = []
    for i in range(n):
        pack_kspace_volume(pre, synthetic_kspace_pairs(seed=20 + i, s=s,
                                                       h=64, w=48),
                           str(root / f"vol{i}"))
        paths.append(str(root / f"vol{i}" / "volume.npz"))
    lst = root / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def test_infer_cli_matches_jax_cli(tmp_path, capsys):
    """The whole slice: one JAX model saved with the JAX checkpoint code and,
    converted, with the port's; both CLIs with --metrics --tta hflip on the
    same two packed volumes."""
    lst = _write_packs(tmp_path / "packs")
    jm = jax_build("unet", "resnet18", "none", classes=1)
    v = jax_variables(jm, 64, seed=3)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    jck, tck = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_ckpt.save_best(jck, params, stats, ARGS)
    checkpoint.save_best(tck, state_dict_from_flax(params, stats), ARGS)
    common = ["--list", lst, "--metrics", "--tta", "hflip", "--save-probs",
              "--batch-size", "4"]
    assert jax_infer.main(["--ckpt", jck, "--out-dir",
                           str(tmp_path / "jax"), *common]) == 0
    jax_out = capsys.readouterr().out
    assert infer.main(["--ckpt", tck, "--out-dir", str(tmp_path / "port"),
                       "--device", "cpu", *common]) == 0
    port_out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax" / "summary.json").read_text())
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["volume"] == w["volume"]
        assert g["num_slices"] == w["num_slices"] == 6
        for key in ("dice", "iou", "hd95", "assd"):
            assert _rel(g[key], w[key]) <= 1e-5, (key, g[key], w[key])
        name = Path(g["volume"]).parent.name
        jp = np.load(tmp_path / "jax" / name / "pred_mask.npy")
        tp = np.load(tmp_path / "port" / name / "pred_mask.npy")
        assert jp.shape == tp.shape == (6, 64, 64) and tp.dtype == np.uint8
        with np.load(tmp_path / "jax" / name / "probs.npz") as z:
            jprobs = z["probs"]
        near = np.abs(jprobs[:, 0] - 0.5) < 1e-5
        np.testing.assert_array_equal(tp[~near], jp[~near])
        assert 0 < tp.sum() < tp.size       # the masks are not trivial
    # the same lines, up to the last printed digits
    assert [ln.split(":")[0] for ln in port_out.splitlines()] == [
        ln.split(":")[0] for ln in jax_out.splitlines()]


def test_infer_cli_refuses_what_is_not_ported(capsys):
    """Depth-sharded 3-D inference, and data-parallel 3-D inference (a
    whole volume is one forward), raise naming their flag, and a run
    needs a checkpoint or an artifact."""
    for flag, says in ((["--ckpt3d", "b.ckpt", "--spatial-parallel", "2"],
                        "--spatial-parallel 2"),
                       (["--spatial-parallel", "2"], "--spatial-parallel 2"),
                       (["--ckpt3d", "b.ckpt", "--data-parallel", "2"],
                        "--data-parallel 2 splits 2-D batches"),
                       (["--quant", "int4"], "invalid choice")):
        with pytest.raises(SystemExit) as e:
            infer.main(["--ckpt", "x.ckpt", "--list", "l.txt", *flag])
        assert e.value.code == 2
        assert says in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        infer.main(["--list", "l.txt"])
    assert e.value.code == 2 and "--qtree" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        infer.main(["--help"])
    help_text = "".join(capsys.readouterr().out.split())
    assert all(f in help_text for f in ("--quant", "--qtree", "--ckpt3d"))


def test_infer_cli_data_parallel_equals_one_device(tmp_path):
    """``--data-parallel 2 --device cpu``: every batch split over two CPU
    model replicas (6 slices at batch 4: the batch stays 4, the volume pads
    to 8); the masks are one device's bit for bit, the metrics equal."""
    lst = _write_packs(tmp_path / "packs", n=1, hw=32)
    model = init_weights(build_unet("unet", "resnet18", classes=1),
                         torch.Generator().manual_seed(5))
    ck = str(tmp_path / "port.ckpt")
    checkpoint.save_best(ck, model.state_dict(), ARGS)
    outs = []
    for extra in ([], ["--data-parallel", "2"]):
        out = tmp_path / f"dp{len(extra)}"
        assert infer.main(["--ckpt", ck, "--list", lst, "--out-dir",
                           str(out), "--metrics", "--batch-size", "4",
                           "--device", "cpu", *extra]) == 0
        outs.append(out)
    one, two = (json.loads((o / "summary.json").read_text()) for o in outs)
    assert [s["dice"] for s in one] == [s["dice"] for s in two]
    np.testing.assert_array_equal(
        np.load(outs[0] / "vol0" / "pred_mask.npy"),
        np.load(outs[1] / "vol0" / "pred_mask.npy"))


def test_infer_cli_warns_for_multiclass(tmp_path, capsys):
    lst = _write_packs(tmp_path / "packs", n=1, s=3, hw=32)
    tm = build_unet("unet", "resnet18", classes=3)
    ck = str(tmp_path / "mc.ckpt")
    checkpoint.save_best(ck, tm.state_dict(), dict(ARGS, classes=3))
    assert infer.main(["--ckpt", ck, "--list", lst, "--metrics", "--out-dir",
                       str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert "WARNING: --metrics" in capsys.readouterr().out
    got = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert "dice" not in got[0]
    pred = np.load(tmp_path / "out" / "vol0" / "pred_mask.npy")
    assert pred.shape == (3, 32, 32) and pred.max() <= 2


@pytest.mark.parametrize("device,fail", [("cuda", False), ("cuda", True),
                                         ("cpu", False)])
def test_f32_on_card_puts_the_flags_back(device, fail):
    """Inside the block a card's f32 convolutions and matmuls leave TF32
    (the flags are process-wide and can be set without a card); after it,
    also after an error, the caller's flags are back. The CPU leaves them
    alone."""
    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    before = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError) if fail else nullcontext():
            with f32_on_card(torch.device(device)):
                assert flags() == ((False, False) if device == "cuda"
                                   else (True, True))
                if fail:
                    raise RuntimeError("inside the block")
        assert flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def test_trainer_test_matches_jax_trainer(tmp_path):
    """``UNet2DTrainer.test`` on one state: the JAX trainer's initial
    weights, saved by each package's checkpoint code."""
    lst = _write_packs(tmp_path / "packs", n=2, s=5, hw=32)
    common = dict(train_list=lst, val_list=lst, encoder="resnet18",
                  batch_size=4, epochs=1, workers=0, logger="noop")
    jt = jtrainer.UNet2DTrainer(jtrainer.UNet2DArgs(
        out_dir=str(tmp_path / "jrun"), **common))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    stats = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    jck, tck = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_ckpt.save_best(jck, params, stats, ARGS)
    checkpoint.save_best(tck, state_dict_from_flax(params, stats), ARGS)
    tt = trainer.UNet2DTrainer(trainer.UNet2DArgs(
        out_dir=str(tmp_path / "trun"), **common), device="cpu")
    want = jt.test(jck, lst)
    got = tt.test(tck, lst)
    assert got.keys() == want.keys() == {"dice", "iou"}
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-5, (key, got, want)
    assert tt.test() == pytest.approx(got, abs=1e-7)   # the val store


def _run_dir(root: Path) -> Path:
    run = root / "run"
    (run / "samples").mkdir(parents=True)
    history = [{"epoch": e, "train_loss": 0.9 / e, "val_loss": 0.8 / e,
                "val_dice": 0.5 + 0.1 * e, "val_iou": 0.4 + 0.1 * e,
                "lr": 1e-3} for e in (1, 2, 3)]
    (run / "history.json").write_text(json.dumps(history))
    (run / "summary.json").write_text(json.dumps(
        {"best": history[2], "final": history[2],
         "best_ckpt": str(run / "best.ckpt"), "epochs": 3}))
    (run / "args.json").write_text(json.dumps(
        {"model": "unet", "encoder": "resnet34", "lr": 1e-3}))
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(run / "samples" / f"sample_{i:04d}.png"),
                  rng.integers(0, 255, (8, 32, 3), dtype=np.uint8))
    return run


def test_report_exporter_matches_jax(tmp_path, capsys):
    run = _run_dir(tmp_path)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = jexporter.export_run_report(str(run), str(tmp_path / "j" /
                                                      "report.html"))
    tpath = exporter.export_run_report(str(run), str(tmp_path / "t" /
                                                     "report.html"))
    for name in ("report.html", "report_metrics.json"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert Path(tpath).name == Path(jpath).name == "report.html"
    assert exporter.main(["--run-dir", str(run)]) == 0
    assert (run / "report.html").read_bytes() == (
        tmp_path / "t" / "report.html").read_bytes()
    assert "[report] wrote" in capsys.readouterr().out
    metrics = json.loads((run / "report_metrics.json").read_text())
    assert metrics["epochs"] == 3 and metrics["best"]["epoch"] == 3


# ---------------------------------------------------------------------------
# bf16 inference of an amp checkpoint; the quantized paths of the CLI
# ---------------------------------------------------------------------------

DEFAULT_DECODER = (256, 128, 64, 32, 16)


def _bf16_spacing(m: float) -> float:
    """The gap between bf16 numbers at magnitude ``m`` (8 significant
    bits)."""
    return float(2.0 ** (np.floor(np.log2(m)) - 7))


def _amp_ckpt(tmp_path, arch):
    """A briefly trained port model with the CLIs' default decoder, saved
    as an ``amp`` checkpoint, and its Flax variables."""
    model = train_port_model(arch, seed=4, decoder=DEFAULT_DECODER)
    ck = str(tmp_path / f"{arch}.ckpt")
    checkpoint.save_best(ck, model.state_dict(),
                         dict(ARGS, model=arch, amp=True))
    jm = JAX_CLS[arch](encoder="resnet18", classes=1, dtype=jnp.bfloat16,
                       fused_decoder=False)
    return ck, jm, flax_variables(jm, model.state_dict())


@pytest.mark.parametrize("arch", ["unet", "unetpp"])
def test_amp_checkpoint_infers_in_bf16_as_jax(tmp_path, arch):
    """The repair: an ``amp`` checkpoint loads with a bf16 compute dtype
    and ``model_apply_fn`` (the CLI's and the daemon's) runs it in bf16.
    Held against the JAX module built with ``dtype=bfloat16`` on the same
    weights; the f32 path the port used before is no bf16 computation and
    fails the same bound."""
    ck, jm, v = _amp_ckpt(tmp_path, arch)
    model, margs = infer.load_model_from_ckpt(ck, "cpu")
    assert margs["amp"] is True and model.compute_dtype == torch.bfloat16
    x = np.random.default_rng(5).standard_normal((4, 64, 64, 1)).astype(
        np.float32)
    x[:, 16:48, 16:48] += 1.5
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    apply_fn = infer.model_apply_fn(model, make_input_norm(False))
    with torch.inference_mode():
        got = apply_fn(nchw(x))
    assert got.dtype == torch.float32
    got = nhwc(got)
    bound = 8 * _bf16_spacing(np.abs(want).max())
    dist = np.abs(got - want)
    assert dist.max() <= bound, (dist.max(), bound)
    assert np.array_equal(np.asarray(jnp.asarray(got).astype(jnp.bfloat16)
                                     .astype(jnp.float32)), got)
    assert (dist == 0).mean() >= 0.25, (dist == 0).mean()
    far = np.abs(want) > bound
    assert far.mean() > 0.5
    np.testing.assert_array_equal((got > 0)[far], (want > 0)[far])
    model.compute_dtype = torch.float32          # the f32 path
    with torch.inference_mode():
        f32 = nhwc(infer.model_apply_fn(model, make_input_norm(False))(
            nchw(x)))
    f32_dist = np.abs(f32 - want)
    assert (f32_dist == 0).mean() < 0.25
    assert dist.mean() < 0.75 * f32_dist.mean(), (dist.mean(),
                                                  f32_dist.mean())


def test_infer_cli_runs_amp_checkpoint_in_bf16(tmp_path):
    """``cli.infer`` on an ``amp`` checkpoint: its probabilities are the
    bf16 ``model_apply_fn``'s, not the f32 model's."""
    lst = _write_packs(tmp_path / "packs", n=1, s=4)
    ck, _, _ = _amp_ckpt(tmp_path, "unet")
    assert infer.main(["--ckpt", ck, "--list", lst, "--save-probs",
                       "--batch-size", "4", "--out-dir",
                       str(tmp_path / "out"), "--device", "cpu"]) == 0
    with np.load(tmp_path / "out" / "vol0" / "probs.npz") as z:
        probs = z["probs"]
    with np.load(tmp_path / "packs" / "vol0" / "volume.npz") as z:
        vol = torch.from_numpy(z["img"])
    model, _ = infer.load_model_from_ckpt(ck, "cpu")
    want = segment.segment_volume_2d(
        infer.model_apply_fn(model, make_input_norm(False)), vol,
        batch_size=4)
    np.testing.assert_array_equal(probs, want.numpy())
    f32 = segment.segment_volume_2d(model, vol, batch_size=4)
    assert not np.array_equal(probs, f32.numpy())


def test_infer_cli_quant_and_qtree(tmp_path, capsys):
    """``--quant int8`` calibrates on the first volume's first 16 slices;
    ``--qtree`` serves a ``cli.quantize`` artifact without ``--ckpt``, and
    an explicit ``--quant folded`` overrides its mode. Each run's
    probabilities equal the engine's in-process ones; the JAX CLI on the
    same artifact agrees within 1e-2."""
    lst = _write_packs(tmp_path / "packs", n=2, s=6)
    ck, jm, v = _amp_ckpt(tmp_path, "unet")
    common = ["--list", lst, "--save-probs", "--batch-size", "4",
              "--metrics"]

    def probs(out):
        with np.load(tmp_path / out / "vol1" / "probs.npz") as z:
            return z["probs"]
    with np.load(tmp_path / "packs" / "vol1" / "volume.npz") as z:
        vol = torch.from_numpy(z["img"])
    norm = make_input_norm(False)
    model, _ = infer.load_model_from_ckpt(ck, "cpu")

    assert infer.main(["--ckpt", ck, "--quant", "int8", "--out-dir",
                       str(tmp_path / "int8"), "--device", "cpu",
                       *common]) == 0
    calib = quantize.calibration_batches(lst, 1, norm, 1, 16)
    eng, tree = QuantizedUNet2D.from_model(
        model, calib, QuantConfig("int8", torch.bfloat16))
    want = segment.segment_volume_2d(lambda x: eng.apply(tree, norm(x)),
                                     vol, batch_size=4)
    np.testing.assert_array_equal(probs("int8"), want.numpy())

    q = str(tmp_path / "q.npz")
    assert quantize.main(["--ckpt", ck, "--list", lst, "--out", q,
                          "--device", "cpu"]) == 0
    eng, tree, meta = quantize.load_engine(q)
    assert meta["compute_dtype"] == "bfloat16" and meta["mode"] == "int8"
    assert infer.main(["--qtree", q, "--out-dir", str(tmp_path / "qtree"),
                       "--device", "cpu", *common]) == 0
    got = probs("qtree")
    want = segment.segment_volume_2d(lambda x: eng.apply(tree, norm(x)),
                                     vol, batch_size=4)
    np.testing.assert_array_equal(got, want.numpy())

    assert infer.main(["--qtree", q, "--quant", "folded", "--out-dir",
                       str(tmp_path / "folded"), "--device", "cpu",
                       *common]) == 0
    folded = QuantizedUNet2D("resnet18", 1, DEFAULT_DECODER,
                             QuantConfig("folded", torch.bfloat16))
    want = segment.segment_volume_2d(lambda x: folded.apply(tree, norm(x)),
                                     vol, batch_size=4)
    np.testing.assert_array_equal(probs("folded"), want.numpy())
    assert not np.array_equal(probs("folded"), got)

    capsys.readouterr()
    assert jax_infer.main(["--qtree", q, "--out-dir", str(tmp_path / "jax"),
                           *common]) == 0
    jp = probs("jax")
    np.testing.assert_allclose(got, jp, rtol=0, atol=1e-2)
    near = np.abs(jp[:, 0] - 0.5) < 1e-2
    pred = np.load(tmp_path / "qtree" / "vol1" / "pred_mask.npy")
    jpred = np.load(tmp_path / "jax" / "vol1" / "pred_mask.npy")
    np.testing.assert_array_equal(pred[~near], jpred[~near])
    summary = json.loads((tmp_path / "qtree" / "summary.json").read_text())
    assert len(summary) == 2 and all(np.isfinite(e["dice"])
                                     for e in summary)
