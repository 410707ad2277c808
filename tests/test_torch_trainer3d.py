"""Parity of the PyTorch port's 3-D patch path with the JAX package: the
``KneeNPZ3D`` sampler, the device volume store, ``UNet3DTrainer`` (short
runs from the same initial parameters, gradient accumulation, resume),
its CLI, ``sliding_window_3d`` and ``cli.infer --ckpt3d``.

Packs are small (12 or 6 slices of 24x24), models narrow (channels (4, 8,
16) or (4, 8)), ROI 16x16x8, f32. The JAX models are initialized through a
seeded numpy kernel initializer in place of ``he_normal``, whose
per-shape compiles take tens of seconds op by op; the values are then
carried to the port by ``state_dict_from_flax_unet3d``. Tolerances, each
stated where it is checked:
- the sampler: patches, masks and batches bit-equal;
- the device store: its positive table equal to JAX's, every patch equal
  to the store's slice at its drawn corner, and at a ratio of 1e6 at least
  90 % of patches holding positives (JAX's test);
- trainers: each epoch's train and val loss within 1e-3 relative, and at
  most 1 % of best3d's parameter elements off by more than 1e-5, none by
  more than 2 * lr * steps (Adam's first steps move an element by about lr
  whatever its gradient's size, as in ``tests/test_torch_train.py``);
- resume: bit-equal;
- sliding window: probabilities within 1e-5;
- ``--ckpt3d``: probabilities within 1e-4, masks equal away from 1e-4 of
  the threshold, Dice / IoU / HD95 / ASSD within 1e-5 relative. The
  volume is zero-padded from 10x24x24 to 16x32x32, and the InstanceNorm's
  one-pass variance over the padded zeros cancels: JAX's jitted forward
  lands 2.8e-4 from a float64 run of the same weights (logits of max
  1.86), the port's 7e-7, so the two sides' probabilities differ by up to
  5.5e-5 (3.6e-6 on the logits of an unpadded volume).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.cli import infer as jinfer
from mri_acl_imagesegmentation_adsp_tpu.data.volume3d import (
    DeviceVolumeStore as JaxStore)
from mri_acl_imagesegmentation_adsp_tpu.infer import segment as jseg
from mri_acl_imagesegmentation_adsp_tpu.models import unet3d as junet3d
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jckpt
from mri_acl_imagesegmentation_adsp_tpu.train import trainer3d as jt3d
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer
from mri_acl_imagesegmentation_adsp_tpu_torch.data.volume3d import (
    DeviceVolumeStore)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    sliding_window_3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.train import trainer3d as t3d

ROI = (16, 16, 8)
LR = 1e-3


def _write_packs(root, slices=(12, 12), seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for v, s in enumerate(slices):
        img = rng.standard_normal((s, 1, 24, 24)).astype(np.float32)
        msk = np.zeros((s, 24, 24), np.uint8)
        msk[s // 3:s // 3 + 4, 8:16, 8:16] = 1   # a compact positive region
        d = root / f"v{v}"
        d.mkdir(parents=True)
        np.savez_compressed(d / "volume.npz", img=img, msk=msk)
        files.append(str(d / "volume.npz"))
    lst = root / "list.txt"
    lst.write_text("\n".join(files))
    return str(lst)


@pytest.fixture
def packs(tmp_path):
    return _write_packs(tmp_path / "packs")


@pytest.fixture
def np_init(monkeypatch):
    """A seeded numpy He-normal kernel initializer for the JAX modules."""
    rng = np.random.default_rng(11)

    def init(key, shape, dtype=jnp.float32):
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((rng.standard_normal(shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32))
    monkeypatch.setattr(junet3d, "_conv_init", init)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slices", [(12, 12), (6, 12)],
                         ids=["equal", "ragged"])
@pytest.mark.parametrize("train", [True, False])
def test_knee_npz3d_bit_equal_to_jax(tmp_path, slices, train):
    """Items, then two shuffled epochs of batches of 3 (the last ragged);
    a 6-slice volume is shallower than the ROI's 8 and zero-pads."""
    lst = _write_packs(tmp_path / "p", slices)
    kw = dict(roi=ROI, samples_per_vol=5, train=train, seed=3)
    jds, tds = jt3d.KneeNPZ3D(lst, **kw), t3d.KneeNPZ3D(lst, **kw)
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        (jx, jy), (tx, ty) = jds[i], tds[i]
        assert tx.shape == (8, 16, 16)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for _ in range(2):
        for (jx, jy), (tx, ty) in zip(jds.batches(3, shuffle=train),
                                      tds.batches(3, shuffle=train)):
            np.testing.assert_array_equal(tx[:, 0], jx[..., 0])
            np.testing.assert_array_equal(ty, jy)


def test_knee_npz3d_cache_is_bounded(packs):
    ds = t3d.KneeNPZ3D(packs, roi=ROI, samples_per_vol=2, seed=0,
                       cache_volumes=1)
    ds._load(0)
    ds._load(1)
    assert len(ds._cache) == 1 and 1 in ds._cache
    x, _ = ds._load(1)
    assert abs(float(x.mean())) < 1e-4


def test_device_store_patch_semantics(tmp_path):
    lst = _write_packs(tmp_path / "p", (6, 12))
    store = DeviceVolumeStore(lst, seed=0, device="cpu")
    jstore = JaxStore(lst, seed=0)
    np.testing.assert_array_equal(store.pos_tab.numpy(),
                                  np.asarray(jstore.pos_tab))
    np.testing.assert_array_equal(store.images.numpy(),
                                  np.asarray(jstore.images))
    roi = (16, 16, 4)
    for ratio, batch in ((1e6, 16), (1.0, 64)):
        gen = torch.Generator().manual_seed(5)
        state = gen.get_state()
        v, start = store.draw_corners(gen, batch, roi, ratio)
        gen.set_state(state)
        x, y = store.sample_batch(gen, batch, roi, ratio)
        assert x.shape == (batch, 1, 4, 16, 16) and y.shape == (batch, 4,
                                                                16, 16)
        for b in range(batch):
            z0, y0, x0 = (int(c) for c in start[b])
            sl = (int(v[b]), slice(z0, z0 + 4), slice(y0, y0 + 16),
                  slice(x0, x0 + 16))
            assert torch.equal(x[b, 0], store.images[sl])
            assert torch.equal(y[b], store.masks[sl])
            # inside the volume's own extent (6 or 12 slices)
            assert z0 + 4 <= int(store.sizes[v[b], 0])
        hits = float((y.reshape(batch, -1).max(dim=1).values > 0)
                     .float().mean())
        if ratio > 1e3:
            assert hits >= 0.9
    assert 0.2 < hits < 1.0    # ratio 1: half the centres uniform
    # a ROI deeper than every volume: the store is padded to its depth and
    # the patches zero-padded, as the host sampler pads them
    deep = DeviceVolumeStore(lst, seed=0, device="cpu", min_depth=16)
    assert deep.images.shape == (2, 16, 24, 24)
    assert torch.equal(deep.images[:, :12], store.images)
    x, _ = deep.sample_batch(torch.Generator().manual_seed(0), 8,
                             (16, 16, 16), 1.0)
    assert x.shape == (8, 1, 16, 16, 16)
    assert not x[:, :, 12:].any()


def test_entry_points_default_to_the_card(packs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    from mri_acl_imagesegmentation_adsp_tpu_torch.tools import make_corpus
    with pytest.raises(RuntimeError, match="cuda"):
        t3d.UNet3DTrainer(_args(t3d.UNet3DArgs, packs, tmp_path / "run"))
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceVolumeStore(packs)
    with pytest.raises(RuntimeError, match="cuda"):
        make_corpus.make_corpus(str(tmp_path / "packs"), volumes=1)
    ck = str(tmp_path / "best3d.ckpt")
    checkpoint.save_best(ck, build_unet3d(1, 1, (4, 8)).state_dict(),
                         {"channels": [4, 8], "classes": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(["--ckpt3d", ck, "--list", packs])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _args(cls, lst, out, **kw):
    base = dict(train_list=lst, val_list=lst, out_dir=str(out), roi=ROI,
                channels=(4, 8, 16), classes=1, batch_size=2, epochs=2,
                lr=LR, amp=False, samples_per_vol_train=4,
                samples_per_vol_val=1, seed=7)
    base.update(kw)
    return cls(**base)


def _log(out):
    with open(os.path.join(out, "train_log.csv"), encoding="utf-8") as f:
        return f.read().splitlines()


def test_trainer_matches_jax(packs, tmp_path, np_init):
    """Two epochs of each trainer from JAX's initial parameters on the same
    packs (the same patches, bit for bit) at accum 2: five microbatches an
    epoch, two full groups and a ragged tail of one that still updates, as
    every microbatch updates at accum 1 (one pair of runs holds both
    rules: each JAX trainer compiles its own steps for seconds)."""
    accum, spv = 2, 5
    jt = jt3d.UNet3DTrainer(_args(jt3d.UNet3DArgs, packs, tmp_path / "j",
                                  accum_steps=accum,
                                  samples_per_vol_train=spv))
    tt = t3d.UNet3DTrainer(_args(t3d.UNet3DArgs, packs, tmp_path / "t",
                                 accum_steps=accum,
                                 samples_per_vol_train=spv), device="cpu")
    tt.model.load_state_dict(state_dict_from_flax_unet3d(
        jax.tree.map(np.asarray, jt.params)))
    jt.fit()
    tt.fit()
    jlog, tlog = _log(tmp_path / "j"), _log(tmp_path / "t")
    assert tlog[0] == jlog[0] == "epoch,train_loss,val_loss,lr"
    assert len(tlog) == len(jlog) == 3
    for jr, tr in zip(jlog[1:], tlog[1:]):
        jv, tv = np.array(jr.split(","), float), np.array(tr.split(","),
                                                          float)
        assert tv[0] == jv[0] and tv[3] == pytest.approx(jv[3])
        np.testing.assert_allclose(tv[1:3], jv[1:3], rtol=1e-3)
    with open(str(tmp_path / "t" / "best3d.ckpt.args.json")) as f:
        assert json.load(f)["accum_steps"] == accum
    got = checkpoint.load_best(str(tmp_path / "t" / "best3d.ckpt"))
    jbest, _ = jckpt.load_best(str(tmp_path / "j" / "best3d.ckpt"),
                               jt.params, {})
    want = state_dict_from_flax_unet3d(jax.tree.map(np.asarray, jbest))
    d = np.concatenate([(got[k] - want[k]).abs().numpy().ravel()
                        for k in want])
    microbatches = -(-len(tt.train_ds) // 2)
    steps = 2 * -(-microbatches // accum)
    assert float((d > 1e-5).mean()) <= 0.01, float((d > 1e-5).mean())
    assert float(d.max()) <= 2 * LR * steps


def test_resume_is_bit_equal_and_preempt_snapshots(packs, tmp_path):
    """Preempted after epoch 2 of 4, then ``resume``: the model, the
    optimizer and train_log.csv equal the straight run's bit for bit (the
    samplers' generator states are in the snapshot)."""
    def trainer(name, **kw):
        return t3d.UNet3DTrainer(_args(t3d.UNet3DArgs, packs,
                                       tmp_path / name, epochs=4,
                                       channels=(4, 8), **kw), device="cpu")
    ref = trainer("ref")
    ref.fit()
    cut = trainer("cut", preempt_save=True, save_resume_every=1,
                  resume_keep=1)
    real = cut.train_one_epoch

    def epoch_then_preempt():
        out = real()
        if len(_log(tmp_path / "cut")) == 2:     # header + epoch 1 so far
            cut.request_preempt()
        return out
    cut.train_one_epoch = epoch_then_preempt
    cut.fit()
    snaps = os.listdir(tmp_path / "cut" / "checkpoints")
    assert snaps == ["resume_000002"], snaps
    res = trainer("cut", resume=True)
    assert res.start_epoch == 3
    res.fit()
    assert _log(tmp_path / "ref") == _log(tmp_path / "cut")
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, res.model.state_dict()[k]), k
    for a, b in zip(ref.optimizer.mu + ref.optimizer.nu,
                    res.optimizer.mu + res.optimizer.nu):
        assert torch.equal(a, b)


def test_device_sampling_trains_and_resumes(packs, tmp_path):
    """``device_sampling``: patches drawn from the device store (4 steps an
    epoch at 8 patches); its generator state is in the snapshot."""
    def run(name, epochs, **kw):
        t = t3d.UNet3DTrainer(_args(t3d.UNet3DArgs, packs, tmp_path / name,
                                    epochs=epochs, channels=(4, 8),
                                    roi=(16, 16, 4), device_sampling=True,
                                    save_resume_every=1, **kw),
                              device="cpu")
        return t, t.fit()
    ref, out = run("ref", 2)
    assert np.isfinite(out["best_val_loss"])
    assert os.path.exists(out["best_ckpt"])
    run("cut", 1)
    res, _ = run("cut", 2, resume=True)
    assert _log(tmp_path / "ref") == _log(tmp_path / "cut")
    assert all(torch.equal(v, res.model.state_dict()[k])
               for k, v in ref.model.state_dict().items())


def test_cli_parses_as_jax_and_refuses_what_is_not_ported(packs, tmp_path):
    argv = ["--train-list", packs, "--val-list", packs,
            "--out-dir", str(tmp_path / "cli"), "--roi", "16", "16", "8",
            "--channels", "4", "8", "--epochs", "1", "--batch-size", "2",
            "--samples-per-vol-train", "2", "--samples-per-vol-val", "1",
            "--accum-steps", "2", "--seed", "3", "--amp",
            "--device-sampling", "--resume-keep", "2"]
    assert t3d.parse_args(argv).__dict__ == jt3d.parse_args(argv).__dict__
    assert ([f.name for f in t3d.UNet3DArgs.__dataclass_fields__.values()]
            == [f.name for f in jt3d.UNet3DArgs.__dataclass_fields__
                .values()])
    assert t3d.UNet3DArgs() == t3d.UNet3DArgs(**jt3d.UNet3DArgs().__dict__)
    assert t3d.main([*argv, "--device", "cpu"]) == 0
    assert _log(tmp_path / "cli")[0] == "epoch,train_loss,val_loss,lr"
    for kw, flag in (({"data_parallel": 2}, "--data-parallel 2 on 1 rank"),
                     ({"spatial_parallel": 2}, "--spatial-parallel 2"),
                     ({"ckpt_backend": "orbax"}, "--ckpt-backend")):
        with pytest.raises(ValueError, match=flag):
            t3d.UNet3DTrainer(_args(t3d.UNet3DArgs, packs,
                                    tmp_path / "no", **kw), device="cpu")
    # --data-parallel 2 through the CLI: two spawned CPU ranks, rank 0
    # writing the one log (its header and one row an epoch)
    assert t3d.main([*argv[:5], str(tmp_path / "dp"), *argv[6:],
                     "--data-parallel", "2", "--device", "cpu"]) == 0
    log = _log(tmp_path / "dp")
    assert log[0] == "epoch,train_loss,val_loss,lr" and len(log) == 2
    assert os.path.isfile(tmp_path / "dp" / "best3d.ckpt")


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_window_model():
    """The JAX (4, 8) model and its jitted forward, shared by the sliding
    window's blends so that it compiles once."""
    jm, p = _flax_3d((4, 8), (1, 8, 16, 16, 1))
    return p, jax.jit(lambda x: jm.apply({"params": p}, x))


def _flax_3d(channels, x_shape, seed=0):
    jm = junet3d.ResidualUNet3D(classes=1, channels=channels,
                                fused_up=False)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))["params"]
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(
        np.float32), shapes)
    return jm, p


@pytest.mark.parametrize("blend", ["gaussian", "uniform"])
def test_sliding_window_3d_matches_jax(jax_window_model, blend):
    """A (12, 20, 28) volume in (8, 16, 16) windows at overlap 0.5: the
    starts include the appended last one on every axis."""
    p, jfwd = jax_window_model
    vol = np.random.default_rng(2).standard_normal((12, 20, 28)).astype(
        np.float32)
    want = jseg.sliding_window_3d(jfwd, vol, roi=(8, 16, 16), blend=blend)
    tm = build_unet3d(1, 1, (4, 8))
    tm.load_state_dict(state_dict_from_flax_unet3d(p))
    got = sliding_window_3d(tm.eval(), torch.from_numpy(vol),
                            roi=(8, 16, 16), blend=blend)
    assert got.shape == want.shape == (1, 12, 20, 28)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_infer_ckpt3d_matches_jax(tmp_path, np_init):
    """One 10x24x24 volume through each CLI's --ckpt3d (padded to
    16x32x32 and cropped back): probabilities, masks and the summary."""
    lst = _write_packs(tmp_path / "p", (10,), seed=4)
    jm, p = _flax_3d((4, 8, 16), (1, 16, 32, 32, 1), seed=1)
    margs = {"channels": [4, 8, 16], "classes": 1, "amp": False}
    ck = {}
    for side in ("jax", "port"):
        ck[side] = str(tmp_path / side / "best3d.ckpt")
        os.makedirs(tmp_path / side)
    jckpt.save_best(ck["jax"], p, {}, margs)
    checkpoint.save_best(ck["port"], state_dict_from_flax_unet3d(p), margs)
    common = ["--list", lst, "--metrics", "--save-probs"]
    assert jinfer.main(["--ckpt3d", ck["jax"], "--out-dir",
                        str(tmp_path / "jp"), *common]) == 0
    assert infer.main(["--ckpt3d", ck["port"], "--out-dir",
                       str(tmp_path / "tp"), "--device", "cpu",
                       *common]) == 0
    jp = np.load(tmp_path / "jp" / "v0" / "probs.npz")["probs"]
    tp = np.load(tmp_path / "tp" / "v0" / "probs.npz")["probs"]
    assert tp.shape == jp.shape == (10, 24, 24)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    jm_, tm_ = (np.load(tmp_path / d / "v0" / "pred_mask.npy")
                for d in ("jp", "tp"))
    near = np.abs(jp - 0.5) < 1e-4
    np.testing.assert_array_equal(tm_[~near], jm_[~near])
    assert 0 < tm_.sum() < tm_.size
    with open(tmp_path / "jp" / "summary.json") as f:
        js = json.load(f)[0]
    with open(tmp_path / "tp" / "summary.json") as f:
        ts = json.load(f)[0]
    for k in ("dice", "iou", "hd95", "assd"):
        assert ts[k] == pytest.approx(js[k], rel=1e-5), k
