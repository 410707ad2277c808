"""Parity of the PyTorch port's classification suite with the JAX package:
``roc_auc``, the image helpers, the augmentations, the schedulers,
``EarlyStopping``, the datasheet datasets on ``.h5`` files written here,
``cli.train_classify`` (YAML run, run directory, ``params.txt``,
``--evaluate``), ``ClassifierTrainer`` (the lr sequence, early stopping,
resume, ``evaluate``'s rebuild from the sidecar) and the ``--task
classify`` daemon.

Bit-equal to JAX: ``roc_auc`` (with ties), the five normalisations and the
ADC / b1500 ones, the center crop, the augmentations (the same Python and
numpy seeds), the scheduler factors, ``EarlyStopping``, the dataset
records, weights and items (the DWI resize with OpenCV present; without it
the port's bilinear resize against JAX's, within 1e-5 of the image's
largest value: two f32 matmuls each side). The trainer's lr sequence, its
plateau and early stopping are held to JAX's over a scripted run of val
losses (no model runs on either side). Models are tiny, f32, on the CPU.
The ``slow`` case trains ``tools/classify_synthetic.py``'s recipe from the
JAX trainer's own initial weights and holds it to the JAX run's record.
"""
import io
import json
import os
import random
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.classify import augment as jaug
from mri_acl_imagesegmentation_adsp_tpu.classify import dataset as jds
from mri_acl_imagesegmentation_adsp_tpu.classify import image_utils as jiu
from mri_acl_imagesegmentation_adsp_tpu.classify import trainer as jtr
from mri_acl_imagesegmentation_adsp_tpu.classify import trainer_utils as jtu
from mri_acl_imagesegmentation_adsp_tpu.cli import train_classify as jcli
from mri_acl_imagesegmentation_adsp_tpu.train import early_stopping as jes
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import augment as taug
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import dataset as tds
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import (
    image_utils as tiu)
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import trainer as ttr
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import (
    trainer_utils as ttu)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import (
    train_classify as tcli)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convnext import ConvNeXt
from mri_acl_imagesegmentation_adsp_tpu_torch.tools import (
    classify_synthetic)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    early_stopping as tes)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
    load_best, save_best)

NO_CV2_RTOL = 1e-5


def test_roc_auc_bit_equal_with_ties():
    rng = np.random.default_rng(3)
    for n in (7, 50, 200):
        y = (rng.random(n) > 0.6).astype(int)
        y[:2] = (0, 1)
        s = np.round(rng.random(n) * 0.5 + y * 0.3, 1)   # many ties
        assert ttr.roc_auc(y, s) == jtr.roc_auc(y, s)
    with pytest.raises(ValueError, match="both classes"):
        ttr.roc_auc(np.zeros(4), np.arange(4.0))


def test_image_helpers_bit_equal():
    rng = np.random.default_rng(4)
    img = np.abs(rng.standard_normal((61, 64))) * 100
    for t in range(1, 6):
        np.testing.assert_array_equal(tiu.normalisation_2d(img, t),
                                      jiu.normalisation_2d(img, t))
    with pytest.raises(ValueError):
        tiu.normalisation_2d(img, 6)
    adc = np.abs(rng.standard_normal((32, 30))) * 4000
    for name in ("normalise_adc", "norm_adc", "norm_b1500"):
        np.testing.assert_array_equal(getattr(tiu, name)(adc),
                                      getattr(jiu, name)(adc))
    for size in ((32, 32), (31, 40), (224, 224)):
        big = np.abs(rng.standard_normal((256, 241)))
        np.testing.assert_array_equal(tiu.center_crop_2d(big, size),
                                      jiu.center_crop_2d(big, size))
    vol = np.abs(rng.standard_normal((3, 40, 36))).astype(np.float32)
    np.testing.assert_array_equal(tiu.diffusion_resize(vol, (20, 24)),
                                  jiu.diffusion_resize(vol, (20, 24)))


def test_augmentations_bit_equal():
    rng = np.random.default_rng(6)
    img = rng.standard_normal((48, 40))
    b, a = rng.standard_normal((2, 48, 40))
    for seed in range(12):
        outs = []
        for mod in (taug, jaug):
            random.seed(seed)
            np.random.seed(seed)
            outs.append((mod.augment_image_t2(img.copy()),
                         mod.augment_image_diffusion(b.copy(), a.copy())))
        (t_t2, t_dw), (j_t2, j_dw) = outs
        np.testing.assert_array_equal(t_t2[0], j_t2[0])
        np.testing.assert_array_equal(t_t2[1], j_t2[1])
        for got, want in zip(t_dw, j_dw):
            np.testing.assert_array_equal(got, want)


def test_schedulers_and_early_stopping_bit_equal():
    for name in ("exponentiallr", "multistep", "cosine", "plat", "none"):
        args = SimpleNamespace(scheduler=name, gamma=0.9,
                               lr_decay_steps=(3, 7))
        ours, theirs = ttu.make_scheduler(args), jtu.make_scheduler(args)
        assert [ours(e) for e in range(40)] == [theirs(e) for e in range(40)]
    losses = [1.0, 0.9, 0.9, 0.95, 0.91, 0.92, 0.89, 0.93, 0.94, 0.95]
    for patience, delta in ((2, 0.0), (3, 0.02)):
        logs = ([], [])
        trackers = [mod.EarlyStopping(patience=patience, delta=delta,
                                      verbose=True, trace_func=log.append,
                                      save_fn=lambda log=log: log.append(
                                          "save"))
                    for mod, log in zip((tes, jes), logs)]
        for v in losses:
            for tr in trackers:
                if not tr.early_stop:
                    tr(v)
        assert logs[0] == logs[1]
        assert [(t.counter, t.best_loss, t.early_stop) for t in trackers][0] \
            == [(t.counter, t.best_loss, t.early_stop) for t in trackers][1]


@pytest.fixture(scope="module")
def sheet(tmp_path_factory):
    """A datasheet and its .h5 files (T2 and DWI), as
    tests/test_classify.py writes them, at sizes that crop and resize."""
    import h5py
    import pandas as pd
    root = tmp_path_factory.mktemp("clf")
    rng = np.random.default_rng(2024)
    rows = []
    (root / "data").mkdir()
    for i in range(8):
        fname = f"case{i}.h5"
        with h5py.File(root / "data" / fname, "w") as hf:
            hf.create_dataset("reconstruction_rss", data=np.abs(
                rng.standard_normal((4, 231, 240))).astype(np.float32))
            hf.create_dataset("b1500", data=np.abs(
                rng.standard_normal((4, 100, 96))).astype(np.float32))
            hf.create_dataset("adc_map", data=(np.abs(
                rng.standard_normal((4, 100, 96))) * 2000).astype(
                    np.float32))
        split = ("training" if i < 4 else "validation" if i < 6
                 else "test")
        rows.append({"fastmri_pt_id": i, "fastmri_rawfile": fname,
                     "folder": ".", "PIRADS": (4, 1, 3, 2)[i % 4],
                     "slice": 1 + i % 4, "data_split": split})
    path = root / "sheet.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path), str(root / "data")


SPLITS = {"train": dict(istrain=True, isval=False, istest=False),
          "val": dict(istrain=False, isval=True, istest=False),
          "test": dict(istrain=False, isval=False, istest=True)}


def _pair(kind, sheet, split, **kw):
    path, root = sheet
    cls = "T2SliceDataset" if kind == "t2" else "DWISliceDataset"
    return [getattr(m, cls)(path, root, **SPLITS[split], **kw)
            for m in (tds, jds)]


@pytest.mark.parametrize("kind", ["t2", "dwi"])
def test_sheet_datasets_bit_equal(sheet, kind):
    kw = {"norm_type": 1} if kind == "t2" else {}
    for split in SPLITS:
        ours, theirs = _pair(kind, sheet, split, augment=False, **kw)
        assert ours.paths == theirs.paths and ours.nums == theirs.nums
        assert ours.slice_num == theirs.slice_num
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        assert ours.weights == theirs.weights and len(ours) == len(theirs)
        for i in range(len(ours)):
            (xo, yo), (xj, yj) = ours[i], theirs[i]
            assert xo.dtype == np.float32 and yo == yj
            np.testing.assert_array_equal(xo, xj)
        for (xo, yo), (xj, yj) in zip(ours.batches(3, True, seed=5),
                                      theirs.batches(3, True, seed=5)):
            np.testing.assert_array_equal(xo, xj)
            np.testing.assert_array_equal(yo, yj)
    assert xo.shape[1:] == ((1, 224, 224) if kind == "t2" else (2, 224, 224))


def test_dwi_without_cv2_and_train_augmentation(sheet, monkeypatch):
    """Without OpenCV both sides resize bilinearly (the port's torch matmuls
    against JAX's); with augmentation on, the same seeds give the same
    items."""
    ours, theirs = _pair("dwi", sheet, "train", augment=True)
    for i in range(len(ours)):
        for mod in (random, np.random):
            mod.seed(i)
        xo, _ = ours[i]
        for mod in (random, np.random):
            mod.seed(i)
        xj, _ = theirs[i]
        np.testing.assert_array_equal(xo, xj)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours, theirs = _pair("dwi", sheet, "val", augment=False)
    for i in range(len(ours)):
        (xo, _), (xj, _) = ours[i], theirs[i]
        np.testing.assert_allclose(xo, xj, rtol=0, atol=NO_CV2_RTOL
                                   * float(np.abs(xj).max()))
    with_cv2 = _pair("dwi", sheet, "val")[1][0][0]
    assert not np.array_equal(xj, with_cv2)    # the fallback really ran


def test_sheet_dataset_names_missing_h5py(sheet, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for cls in (tds.T2SliceDataset, tds.DWISliceDataset):
        with pytest.raises(ImportError, match="h5py"):
            cls(*sheet)


def test_cli_yaml_rundir_params_and_evaluate(sheet, tmp_path, capsys):
    """The vendored surface: a YAML run lands in
    results_fol/<rundir>_SEED_<seed> with params.txt and test_metrics.json,
    and --evaluate reloads the best checkpoint; the YAML maps to JAX's
    ClassifierArgs, and an index to JAX's seed."""
    import yaml
    path, root = sheet
    cfg = {"model_args": {"model": "tiny", "patience": 3, "rundir": "t2cli",
                          "optimizer": "adam", "amsgrad": True,
                          "scheduler": "multistep", "gamma": 0.5,
                          "lr_decay_steps": [1], "lr": 1e-4,
                          "weight_decay": 1e-4},
           "data": {"datasheet": path, "data_location": root,
                    "norm_type": 2},
           "training": {"augment": False, "max_epochs": 1},
           "results_fol": str(tmp_path / "results")}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    seed = tcli._seed_for_index(3)
    assert seed == jcli._seed_for_index(3)
    ours = tcli._args_from_yaml(str(cfg_path), "t2", seed)
    theirs = jcli._args_from_yaml(str(cfg_path), "t2", seed)
    assert vars(ours) == vars(theirs)

    assert tcli.main(["--mode", "t2", "--config-file", str(cfg_path),
                      "--index-seed", "0", "--batch-size", "2", "--no-amp",
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run_dir = os.path.dirname(out["best_ckpt"])
    assert run_dir == str(tmp_path / "results" / (
        f"t2cli_SEED_{tcli._seed_for_index(0)}"))
    assert (open(os.path.join(run_dir, "params.txt")).read()
            == cfg_path.read_text())
    with open(os.path.join(run_dir, "test_metrics.json")) as f:
        assert json.load(f) == out["test"]
    assert out["epochs_ran"] == 1 and out["test"]["n"] == 2
    saved = json.load(open(out["best_ckpt"] + ".args.json"))
    assert saved["amsgrad"] and saved["batch_size"] == 2
    assert tcli.main(["--mode", "t2", "--datasheet", path, "--data-path",
                      root, "--batch-size", "2", "--no-amp", "--norm-type",
                      "2", "--evaluate", out["best_ckpt"], "--device",
                      "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["split"] == "test" and ev["n"] == 2
    assert ev["loss"] == out["test"]["loss"]
    # --data-parallel 2: two spawned CPU ranks split each test batch of 2
    # and gather the logits; this process prints rank 0's result
    assert tcli.main(["--mode", "t2", "--datasheet", path, "--data-path",
                      root, "--batch-size", "2", "--no-amp", "--norm-type",
                      "2", "--evaluate", out["best_ckpt"], "--device",
                      "cpu", "--data-parallel", "2"]) == 0
    dp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dp["n"] == 2 and dp["auc"] == ev["auc"]
    assert dp["loss"] == pytest.approx(ev["loss"], rel=1e-6)


class _Split:
    """A dataset stand-in: weights and no batches."""

    def __init__(self, weights):
        self.weights = weights

    def __len__(self):
        return 0

    def batches(self, *a, **k):
        return iter(())


def test_lr_sequence_plateau_and_early_stopping_match_jax(tmp_path):
    """The lr of each epoch (``lr * sched(ep - 1) * plateau.lr``), the
    secondary plateau and early stopping over a scripted run of val
    losses: the port's fit and JAX's give the same history."""
    val = iter([])
    script = [0.9, 0.8, 0.85, 0.86, 0.87, 0.7, 0.75, 0.76, 0.77, 0.78,
              0.79, 0.8, 0.81]
    hist = {}
    for name, mod in (("port", ttr), ("jax", jtr)):
        args = mod.ClassifierArgs(out_dir=str(tmp_path / name), lr=1e-3,
                                  scheduler="multistep", gamma=0.5,
                                  lr_decay_steps=(2, 4), epochs=20,
                                  patience=6)
        kw = {"device": "cpu"} if mod is ttr else {}
        tr = mod.ClassifierTrainer(args, _Split([0.4, 0.6]),
                                   _Split([0.5, 0.5]), **kw)
        val = iter(script)
        tr._epoch_pass = (lambda train, ds=None, val=val:
                          (0.5, 0.5) if train else (next(val), 0.5))
        tr._save_best = lambda: None
        hist[name] = tr.fit()["history"]
    assert hist["port"] == hist["jax"]
    assert len(hist["port"]) == 12                  # early stopping fired
    # multistep halves at epochs 3 and 5; the plateau (patience 2) halves
    # after epoch 5's third worse loss
    assert [h["lr"] for h in hist["port"]][:6] == pytest.approx(
        [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4, 1.25e-4])


@pytest.mark.slow
def test_recipe_from_jax_init_repeats_the_jax_run(tmp_path):
    """The synthetic recipe from the weights the JAX trainer draws
    (``PRNGKey(42)`` on the first batch), carried across: early stopping
    fires at the JAX run's epoch (18, ``runs/classify_synthetic/
    history.json``) with the same learning rates. From the port's own
    seeded init the same recipe need not stop early: its val loss keeps
    creeping down (a CPU run went all 60 epochs)."""
    import jax
    import jax.numpy as jnp
    from mri_acl_imagesegmentation_adsp_tpu.models.convnext import (
        ConvNeXt as JConvNeXt)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
        state_dict_from_flax_convnext)
    root = Path(__file__).resolve().parents[1]
    with open(root / "runs" / "classify_synthetic" / "history.json") as f:
        record = json.load(f)
    train, val = classify_synthetic.make_datasets()
    x, _ = next(train.batches(16, shuffle=False))
    jm = JConvNeXt(variant="tiny", in_chans=2, num_classes=1)
    params = jax.jit(lambda k, x: jm.init(k, x, train=True))(
        jax.random.PRNGKey(42), jnp.asarray(np.moveaxis(x, 1, -1)))["params"]
    tr = ttr.ClassifierTrainer(classify_synthetic.recipe_args(
        str(tmp_path)), train, val, device="cpu")
    tr.model.load_state_dict(state_dict_from_flax_convnext(
        jax.tree_util.tree_map(np.asarray, params)))
    hist = tr.fit()["history"]
    assert tr.early.early_stop and len(hist) == len(record) == 18
    assert [h["lr"] for h in hist] == [h["lr"] for h in record]
    assert max(h["val_auc"] for h in hist) == 1.0


def _tiny_datasets(seed=0, n=6, hw=32):
    """Synthetic 2-channel slices with the sheet datasets' interface."""
    rng = np.random.default_rng(seed)
    ds = classify_synthetic.SyntheticDWIDataset.__new__(
        classify_synthetic.SyntheticDWIDataset)
    ds.xs = [rng.standard_normal((2, hw, hw)).astype(np.float32)
             for _ in range(n)]
    ds.labels = np.arange(n) % 2
    ds.weights = [0.5, 0.5]
    return ds


def _args(out_dir, **kw):
    return ttr.ClassifierArgs(out_dir=str(out_dir), model="tiny", diff=True,
                              amp=False, epochs=3, batch_size=4, lr=1e-3,
                              **kw)


def test_preempted_run_resumed_equals_straight(tmp_path):
    """Preempted after epoch 1 of 3 and resumed in a new trainer (the
    AMSGrad chain, whose snapshot holds ``nu_max``): the history and the
    best checkpoint equal a straight run's."""
    tr_ds, val = _tiny_datasets(0), _tiny_datasets(1)
    straight = ttr.ClassifierTrainer(_args(tmp_path / "a", amsgrad=True),
                                     tr_ds, val, device="cpu")
    want = straight.fit()["history"]
    tr = ttr.ClassifierTrainer(_args(tmp_path / "b", amsgrad=True), tr_ds,
                               val, device="cpu")
    one_pass = tr._epoch_pass

    def preempting(train, ds=None):
        res = one_pass(train, ds)
        if not train and tr.epoch == 1:
            tr.request_preempt()
        return res
    tr._epoch_pass = preempting
    assert len(tr.fit()["history"]) == 1
    again = ttr.ClassifierTrainer(_args(tmp_path / "b", amsgrad=True),
                                  tr_ds, val, device="cpu")
    got = again.fit(resume=True)["history"]
    assert got == want
    a, b = (load_best(str(p / "classifier_best.ckpt"))
            for p in (tmp_path / "a", tmp_path / "b"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_evaluate_rebuilds_from_sidecar_and_refusals(tmp_path):
    train, val = _tiny_datasets(0), _tiny_datasets(1)
    other = ConvNeXt("tiny", 2)
    ckpt = str(tmp_path / "other.ckpt")
    save_best(ckpt, other.state_dict(), {"model": "tiny", "diff": True,
                                         "amp": False})
    tr = ttr.ClassifierTrainer(ttr.ClassifierArgs(
        out_dir=str(tmp_path / "t"), model="tiny", diff=True, amp=True),
        train, val, device="cpu")
    res = tr.evaluate(val, ckpt)
    assert tr.model.dtype == torch.float32 and res["n"] == len(val)
    assert all(torch.equal(tr.model.state_dict()[k], v)
               for k, v in other.state_dict().items())
    assert np.isnan(tr.evaluate(_Split([0.5, 0.5]))["auc"])
    params = list(tr.model.parameters())
    plain = ttr.make_classifier_optimizer(_args(tmp_path), params)
    ams = ttr.make_classifier_optimizer(_args(tmp_path, amsgrad=True),
                                        params)
    with pytest.raises(ValueError, match="nu_max"):
        plain.load_state_dict(ams.state_dict())
    with pytest.raises(ValueError, match="data_parallel 2 on 1 rank.*"
                       "cli.train_classify --data-parallel"):
        ttr.ClassifierTrainer(ttr.ClassifierArgs(
            out_dir=str(tmp_path / "dp"), data_parallel=2), train, val,
            device="cpu")


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_classify_daemon_matches_direct_forward(tmp_path):
    """``--task classify``: weights load at the first request; replies
    equal the model's sigmoid; 400 for a wrong channel count or a missing
    ``x``; 404 for the segment routes; ``/metricsz`` counts."""
    model = ConvNeXt("tiny", 1)
    ckpt = str(tmp_path / "classifier_best.ckpt")
    save_best(ckpt, model.state_dict(), {"model": "tiny", "diff": False,
                                         "amp": False})
    server = serve.create_server(SimpleNamespace(
        task="classify", ckpt=ckpt, host="127.0.0.1", port=0, batch_size=4,
        warmup_shape="", device="cpu"))
    runner = server.RequestHandlerClass.runner
    assert runner.task == "classify" and not runner._loaded
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        x = np.random.default_rng(9).standard_normal(
            (3, 40, 36)).astype(np.float32)
        code, body = _post(url + "/v1/classify", _npz(x=x))
        assert code == 200
        with np.load(io.BytesIO(body)) as z:
            got = z["probs"]
        with torch.no_grad():
            want = torch.sigmoid(model.eval()(torch.from_numpy(x)[:, None])
                                 [:, 0]).numpy()
        assert got.shape == (3,)
        np.testing.assert_array_equal(got, want)
        assert _post(url + "/v1/classify", _npz(x=x[..., None].repeat(
            2, -1)))[0] == 400
        assert _post(url + "/v1/classify", _npz(img=x))[0] == 400
        assert _post(url + "/v1/segment", _npz(img=x))[0] == 404
        assert _post(url + "/v1/segment_kspace", _npz(kspace=x))[0] == 404
        with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
            text = r.read().decode()
        counts = {ln.split()[0]: float(ln.split()[1])
                  for ln in text.splitlines() if not ln.startswith("#")}
        assert counts["serve_requests_total"] == 1
        assert counts["serve_slices_total"] == 3
        assert counts["serve_errors_total"] == 2
    finally:
        server.shutdown()
        server.server_close()
        runner.close()
        thread.join(timeout=30)
    assert not thread.is_alive()
