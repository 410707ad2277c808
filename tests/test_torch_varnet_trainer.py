"""Parity of the PyTorch port's recon training and serving with the JAX
package: ``combine_directions``, two ``VarNetTrainer`` steps and two
``UnetReconTrainer`` steps from the same weights, the optax RMSprop,
``validate``'s slice dedup and per-volume aggregation, ``reconstruct``'s
export, same-shape batching with its early flush, resume and preemption,
``SliceDataset`` / ``FastMriDataModule`` on small DWI ``.h5`` fixtures,
``cli.train_varnet`` and ``cli.evaluate``, and ``_ReconRunner`` and the
``--task recon`` daemon.

Models are narrow (2 cascades, so that a ``dc_weight`` has a gradient:
the first cascade's soft DC term is zero; ``chans`` 4, 2 pools, ``sens_chans`` 4, 2
coils, 20x16 k-space, crop 12; the recon U-Net ``chans`` 4, 2 pools), f32.
The JAX models initialize through a seeded numpy kernel initializer in
place of ``he_normal`` (per-shape compiles op by op take tens of seconds),
and their parameters are carried to the port by ``models/convert.py``.
Tolerances, each stated where it is checked:
- ``combine_directions``: within 1e-6 relative;
- trainer steps: the first step's gradients tensor by tensor, each within
  ``GRAD_RTOL`` of that tensor's max |g| (the optimizers move an element
  by about lr whatever its gradient's size, so only the gradients show a
  wrong one); each step's loss within ``LOSS_RTOL`` relative; after two
  steps at most 1 % of parameter elements off by more than 1e-5, and none
  by more than ``2 * lr * steps`` (a gradient that is rounding noise on
  both sides may take either sign, as in ``tests/test_torch_train.py``);
- RMSprop: the port within 1e-6 of optax's updates over three steps, and
  ``torch.optim.RMSprop`` (eps outside the root) more than 1e-3 off;
- ``validate`` / ``reconstruct`` / the runner: within ``F32_RTOL`` of the
  output's maximum, or of each metric;
- ``SliceDataset``: k-space within 1e-6 of its maximum (the readout
  regridding's f32 matmul), everything else equal.
"""
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.cli import evaluate as jevaluate
from mri_acl_imagesegmentation_adsp_tpu.cli import serve as jserve
from mri_acl_imagesegmentation_adsp_tpu.data import recon_data as jrd
from mri_acl_imagesegmentation_adsp_tpu.data import transforms as jtf
from mri_acl_imagesegmentation_adsp_tpu.models import fastmri_unet as jfm
from mri_acl_imagesegmentation_adsp_tpu.parallel.mesh import (
    volume_affine_shards)
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jckpt
from mri_acl_imagesegmentation_adsp_tpu.train import unet_recon_trainer as jut
from mri_acl_imagesegmentation_adsp_tpu.train import varnet_trainer as jvt
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import evaluate, serve
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import train_varnet
from mri_acl_imagesegmentation_adsp_tpu_torch.data import recon_data
from mri_acl_imagesegmentation_adsp_tpu_torch.data import transforms as ttf
from mri_acl_imagesegmentation_adsp_tpu_torch.data.transforms import (
    VarNetSample)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_fastmri_unet, state_dict_from_flax_varnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
    init_fastmri_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.varnet_synthetic import (
    write_dwi_h5)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.train import optim
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    unet_recon_trainer as tut)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    varnet_trainer as tvt)

LR = 1e-3
LOSS_RTOL = 1e-4
F32_RTOL = 5e-5
GRAD_RTOL = 5e-5
NARROW = dict(num_cascades=2, chans=4, pools=2, sens_chans=4, sens_pools=2,
              lr=LR, crop=12, amp=False, bvalue="custom", epochs=1)


_INIT = {"rng": np.random.default_rng(21)}


def _reset_init(seed: int) -> None:
    """Restart the JAX kernels' numpy stream, so that a model's weights do
    not depend on which tests ran before it."""
    _INIT["rng"] = np.random.default_rng(seed)


@pytest.fixture(scope="module", autouse=True)
def np_init():
    """A seeded numpy He-normal kernel initializer for the JAX modules."""
    def init(key, shape, dtype=jnp.float32):
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((_INIT["rng"].standard_normal(shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32))
    old = jfm._conv_init
    jfm._conv_init = init
    yield
    jfm._conv_init = old


def _samples(n, seed, h=20, w=16, coils=2, aves=1, vol="vol", th=18):
    """VarNet samples: masked random k-space, RSS-1 maps with one average,
    a positive target of ``th`` rows (so the output is cropped to it)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = rng.standard_normal((coils, aves, h, w, 2)).astype(np.float32)
        k[..., 1::3, :] = 0.0
        e = rng.standard_normal((coils, 1, h, w, 2)).astype(np.float32)
        e /= np.sqrt((e ** 2).sum(axis=(0, 4), keepdims=True))
        t = (0.5 + rng.random((th, w))).astype(np.float32)
        out.append(VarNetSample(k, t, e, f"{vol}{i // 2}", i % 2,
                                float(t.max()), (h, w)))
    return out


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's lowest backend
    optimization level, which halves its CPU compile time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _params_equal_rule(got: dict, want: dict, steps: int) -> None:
    diff = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel()
                           for k in want])
    assert (diff > 1e-5).mean() <= 0.01, (diff > 1e-5).mean()
    assert diff.max() <= 2 * LR * steps, diff.max()


def _flat_sd(params, convert) -> dict:
    return {k: v.numpy() for k, v in convert(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def _grads_equal_rule(model: torch.nn.Module, got, want: dict) -> None:
    """The port's gradients (in ``model.parameters()`` order) against the
    JAX gradient tree carried over by the same converter as the weights
    (a linear map: transposes and flips), tensor by tensor."""
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    # a gradient zero in exact arithmetic (the first cascade's dc_weight:
    # its soft DC term is zero) must be zero here too
    rel = {n: float(np.abs(g.numpy() - want[n]).max())
           / max(float(np.abs(want[n]).max()), 1e-30)
           for n, g in zip(names, got)}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_RTOL, (worst, rel[worst])


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A JAX and a port VarNetTrainer on the same samples and weights."""
    root = tmp_path_factory.mktemp("vt")
    train = _samples(4, 0)
    val = _samples(4, 1, vol="val") + _samples(1, 1, vol="val")  # a dup
    jt = jvt.VarNetTrainer(jvt.VarNetArgs(out_dir=str(root / "j"), **NARROW),
                           train, val)
    s0 = train[0]
    # its plain lowering, which compiles in a third of the phase one's time
    # (test_torch_varnet.py holds the two equal)
    jt.model = jt.model.clone(phase_max_chans=0)
    # JAX's _init_if_needed, its init jitted (eagerly it compiles op by op)
    _reset_init(1)
    jt.params = jax.jit(jt.model.init)(jax.random.PRNGKey(jt.args.seed),
                                       s0.kspace[None], s0.espirit[None])[
        "params"]
    jt.opt_state = jt.tx.init(jt.params)
    k, e = s0.kspace[None], s0.espirit[None]
    jt._train_step = _compiled(jt._train_step_impl, jt.params, jt.opt_state,
                               k, e, s0.target[None],
                               np.float32([s0.max_value]))
    jt._fwd = _compiled(jt._fwd_impl, jt.params, k, e)
    tt = tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=str(root / "t"), **NARROW),
                           train, val, device="cpu")
    tt._init_if_needed(s0.kspace, s0.espirit)
    tt.model.load_state_dict(state_dict_from_flax_varnet(
        jax.tree_util.tree_map(np.asarray, jt.params)))
    return jt, tt, root


def test_combine_directions_matches_jax():
    rng = np.random.default_rng(2)
    for a in (1, 3, 12):
        x = (0.1 + rng.random((2, a, 6, 5))).astype(np.float32)
        got = tvt.combine_directions(torch.from_numpy(x)).numpy()
        want = np.asarray(jvt.combine_directions(jnp.asarray(x)))
        assert got.shape == want.shape == (2, 6, 5)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_varnet_trainer_two_steps_match_jax(trainers):
    """Two SSIM-loss AdamW steps (the second at the first's weights) on the
    same batch: losses and parameters."""
    jt, tt, _ = trainers
    batch = jt.train_ds[:1]
    inputs = tuple(np.stack([getattr(s, f) for s in batch])
                   for f in ("kspace", "espirit", "target")) + (
        np.float32([s.max_value for s in batch]),)
    grad = jax.grad(lambda p, *a: jt._loss(p, *a)[0])
    jg = _compiled(grad, jt.params, *inputs)(jt.params, *inputs)
    _, tg = tt.loss_and_grads(*tt.upload_batch(batch))
    _grads_equal_rule(tt.model, tg, _flat_sd(jg, state_dict_from_flax_varnet))
    jl = [float(jt._step_batch(batch)) for _ in range(2)]
    tl = [float(tt._step_batch(batch)) for _ in range(2)]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (tl, jl)
    _params_equal_rule(tt.model.state_dict(),
                       _flat_sd(jt.params, state_dict_from_flax_varnet), 2)
    # the same weights again for the tests that follow
    tt.model.load_state_dict(state_dict_from_flax_varnet(
        jax.tree_util.tree_map(np.asarray, jt.params)))


def test_validate_dedup_aggregation_matches_jax(trainers):
    """The val set repeats one (volume, slice): both sides count it once in
    the per-volume NMSE and SSIM, and the loss averages every sample (PSNR
    takes the volume's last-seen slice's maximum, on both sides)."""
    jt, tt, _ = trainers
    got, want = tt.validate(), jt.validate()
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= F32_RTOL * max(1.0, abs(want[k])), (
            k, got, want)
    unique = tvt.VarNetTrainer(tt.args, None, tt.val_ds[:4], device="cpu")
    unique.model, unique.optimizer = tt.model, tt.optimizer
    got_u = unique.validate()
    for k in ("nmse", "ssim"):
        assert got_u[k] == pytest.approx(got[k], rel=1e-6)
    assert got_u["validation_loss"] != got["validation_loss"]


def test_reconstruct_export_matches_jax(trainers, tmp_path):
    jt, tt, _ = trainers
    pytest.importorskip("h5py")
    import h5py
    got = tt.reconstruct(tt.val_ds, out_dir=str(tmp_path / "t"))
    want = jt.reconstruct(jt.val_ds, out_dir=str(tmp_path / "j"))
    assert got.keys() == want.keys() == {"val0", "val1"}
    for f in want:
        assert got[f].shape == want[f].shape == (2, 20, 16)
        assert np.abs(got[f] - want[f]).max() <= F32_RTOL * np.abs(
            want[f]).max()
        with h5py.File(tmp_path / "t" / f, "r") as hf:
            np.testing.assert_array_equal(hf["reconstruction"][()], got[f])


def test_batching_flushes_on_a_shape_change_as_jax(tmp_path, monkeypatch):
    """Batches of up to 3 same-shape samples, cut early where the k-space
    or the target changes shape: the same groups on both sides."""
    ds = (_samples(2, 3) + _samples(1, 4, h=24) + _samples(4, 5)
          + _samples(1, 6, th=16))
    seen = {}
    for name, mod in (("jax", jvt), ("port", tvt)):
        kw = {"device": "cpu"} if name == "port" else {}
        tr = mod.VarNetTrainer(mod.VarNetArgs(
            out_dir=str(tmp_path / name), batch_size=3), ds, [], **kw)
        groups = []
        monkeypatch.setattr(tr, "_step_batch", lambda b, g=groups: (
            g.append([(s.kspace.shape, s.target.shape) for s in b])
            or torch.tensor(0.5)))
        tr.train_one_epoch()
        seen[name] = groups
    assert seen["port"] == seen["jax"]
    assert [len(g) for g in seen["port"]] == [2, 1, 3, 1, 1]


def _fit(root, epochs, resume=False, preempt=False, every=1):
    tr = tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=str(root), **{
        **NARROW, "epochs": epochs}), _samples(3, 7), _samples(2, 8),
        device="cpu")
    if preempt:
        tr.request_preempt()
    out = tr.fit(resume=resume, save_resume_every=every)
    return tr, out


def test_resume_and_preemption_bit_equal(tmp_path):
    """A run preempted after epoch 1 (its snapshot written at the cut) and
    resumed equals a straight 2-epoch run bit for bit."""
    straight, h_straight = _fit(tmp_path / "a", 2, every=0)
    cut, h_cut = _fit(tmp_path / "b", 2, preempt=True, every=0)
    assert [h["epoch"] for h in h_cut["history"]] == [1]
    assert checkpoint.latest_resume_dir(str(tmp_path / "b")).endswith(
        "resume_000001")
    resumed, h_res = _fit(tmp_path / "b", 2, resume=True, every=0)
    assert resumed.epoch == 2 and [h["epoch"] for h in h_res["history"]] == [2]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert h_res["history"][0]["train_loss"] == h_straight["history"][1][
        "train_loss"]
    sd = checkpoint.load_best(str(tmp_path / "b" / "varnet_best.ckpt"))
    assert set(sd) == set(straight.model.state_dict())


@pytest.mark.parametrize("kw,match", [
    ({"mesh": object()}, "ReconGrid"),
    ({"pipe_mesh": object()}, "DataGroup"),
    ({"ckpt_backend": "orbax"}, "orbax"),
    pytest.param({"ckpt_async": True}, None, id="kw3-orbax")])
def test_varnet_trainer_refusals(kw, match, tmp_path):
    """A ``mesh`` must be a ``ReconGrid`` and a ``pipe_mesh`` a
    ``DataGroup`` (the grid runs: ``tests/test_torch_varnet_shard.py``;
    the pipe: ``tests/test_torch_pipeline.py``); the orbax backend is
    refused. ``ckpt_async``, which JAX takes only with orbax, is accepted
    with the port's own format and runs: an epoch publishes its snapshot
    (the id of the case is the one it had as a refusal)."""
    args = {k: v for k, v in kw.items() if k.startswith("ckpt")}
    if match is None:
        tr = tvt.VarNetTrainer(tvt.VarNetArgs(
            out_dir=str(tmp_path), **{**NARROW, "epochs": 1}, **args),
            _samples(3, 7), _samples(2, 8), device="cpu")
        tr.fit(save_resume_every=1)
        assert tr.snapshots.pending is None
        assert checkpoint.latest_resume_dir(str(tmp_path)).endswith(
            "resume_000001")
        return
    meshes = {k: v for k, v in kw.items() if k.endswith("mesh")}
    with pytest.raises(TypeError if meshes else ValueError, match=match):
        tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=str(tmp_path), **args),
                          device="cpu", **meshes)


# ---------------------------------------------------------------------------
# The recon U-Net and its optimizer
# ---------------------------------------------------------------------------

def test_rmsprop_matches_optax_and_torch_rmsprop_does_not():
    """Three steps from the same gradients: the port's ``RMSprop`` gives
    optax's parameters; ``torch.optim.RMSprop`` (eps outside the root)
    does not, at gradients small enough that eps matters."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 4)).astype(np.float32)
    gs = [(1e-4 * rng.standard_normal(p0.shape)).astype(np.float32)
          for _ in range(3)]
    tx = optax.rmsprop(LR, decay=0.99, eps=1e-8)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in gs:
        u, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, u)
    want = np.asarray(p)

    def run(make):
        w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([w])
        for g in gs:
            if isinstance(opt, torch.optim.Optimizer):
                w.grad = torch.from_numpy(g)
                opt.step()
            else:
                opt.step([torch.from_numpy(g)])
        return w.detach().numpy()
    got = run(lambda ps: optim.RMSprop(ps, LR, decay=0.99, eps=1e-8))
    np.testing.assert_allclose(got, want, atol=1e-6)
    off = run(lambda ps: torch.optim.RMSprop(ps, lr=LR, alpha=0.99,
                                             eps=1e-8))
    assert np.abs(off - want).max() > 1e-3


def test_unet_recon_trainer_two_steps_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    ds = [tut.unet_transform(rng.random((16, 20)).astype(np.float32),
                             rng.random((16, 20)).astype(np.float32),
                             f"v{i}", i, 1.0) for i in range(4)]
    img, tgt = rng.random((2, 16, 20)).astype(np.float32)
    for a, b in zip(tut.unet_transform(img, tgt, "x", 0, 1.0),
                    jut.unet_transform(img, tgt, "x", 0, 1.0)):
        np.testing.assert_array_equal(a, b)
    kw = dict(chans=4, num_pool_layers=2, amp=False, lr=LR, batch_size=2,
              epochs=1)
    jt = jut.UnetReconTrainer(jut.UnetReconArgs(out_dir=str(tmp_path / "j"),
                                                **kw), ds, ds)
    tt = tut.UnetReconTrainer(tut.UnetReconArgs(out_dir=str(tmp_path / "t"),
                                                **kw), ds, ds, device="cpu")
    (jx, jy), (tx, ty) = (next(jt._batches(ds, False)),
                          next(tt._batches(ds, False)))
    np.testing.assert_array_equal(np.asarray(jx)[..., 0], tx[:, 0].numpy())
    _reset_init(2)
    jt.params = jax.jit(jt.model.init)(jax.random.PRNGKey(0), jx)["params"]
    jt.opt_state = jt.tx.init(jt.params)
    jt._step = _compiled(jt._step_impl, jt.params, jt.opt_state, jx, jy)
    tt.model.load_state_dict(state_dict_from_flax_fastmri_unet(
        jax.tree_util.tree_map(np.asarray, jt.params)))
    grad = jax.grad(lambda p, x, y: jnp.mean(jnp.abs(
        jt.model.apply({"params": p}, x) - y)))     # the JAX step's L1 loss
    jg = _compiled(grad, jt.params, jx, jy)(jt.params, jx, jy)
    _, tg = tt.loss_and_grads(tx, ty)
    _grads_equal_rule(tt.model, tg,
                      _flat_sd(jg, state_dict_from_flax_fastmri_unet))
    jl = []
    for _ in range(2):
        jt.opt_state.hyperparams["learning_rate"] = jnp.asarray(
            jt._lr_now(), jnp.float32)
        jt.params, jt.opt_state, loss = jt._step(jt.params, jt.opt_state,
                                                 jx, jy)
        jl.append(float(loss))
    tl = [float(tt.step(tx, ty)) for _ in range(2)]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (tl, jl)
    _params_equal_rule(tt.model.state_dict(),
                       _flat_sd(jt.params, state_dict_from_flax_fastmri_unet),
                       2)
    # the seeded shuffle: default_rng(seed + epoch), as JAX draws it
    tt.epoch = jt.epoch = 3
    for (_, a), (_, b) in zip(tt._batches(ds, True), jt._batches(ds, True)):
        np.testing.assert_array_equal(a[:, 0].numpy(), np.asarray(b)[..., 0])
    tt.epoch = 0
    out = tt.fit()
    assert os.path.exists(out["best_ckpt"]) and len(out["history"]) == 1
    assert set(checkpoint.load_best(out["best_ckpt"])) == set(
        tt.model.state_dict())


# ---------------------------------------------------------------------------
# The .h5 datasets and CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dwi_root(tmp_path_factory):
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("dwi")
    for split, seeds in (("train", (0, 1)), ("val", (2, 0)), ("test", (3,))):
        (root / split).mkdir()
        for i, seed in enumerate(seeds):
            write_dwi_h5(str(root / split / f"case{i}.h5"), seed,
                         slices=2 if seed else 3)
    return root


@pytest.mark.parametrize("bvalue", ["b50", "b1000"])
def test_slice_dataset_matches_jax(dwi_root, bvalue):
    tf_t, tf_j = ttf.VarNetDataTransform(), jtf.VarNetDataTransform()
    got = recon_data.SliceDataset(dwi_root / "train", bvalue, tf_t,
                                  device="cpu")
    want = jrd.SliceDataset(dwi_root / "train", bvalue, tf_j)
    assert len(got) == len(want) == 5
    assert [e[1:] for e in got.examples] == [e[1:] for e in want.examples]
    for i in (0, 4):
        g, w = got[i], want[i]
        assert g.kspace.shape == w.kspace.shape == (
            2, 3 if bvalue == "b50" else 12, 200, 16, 2)
        assert np.abs(g.kspace - w.kspace).max() <= 1e-6 * np.abs(
            w.kspace).max()
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    raw = recon_data.SliceDataset(dwi_root / "val", bvalue, device="cpu")[1]
    assert raw[2].shape == (2, 1, 200, 16, 2) and raw[4] == "case0.h5"
    assert len(recon_data.SliceDataset(dwi_root / "train", bvalue,
                                       num_cols=(15,), device="cpu")) == 0
    with pytest.raises(ValueError, match="bvalue"):
        recon_data.SliceDataset(dwi_root / "train", "b800", device="cpu")


def test_data_module_and_val_shards(dwi_root):
    dm = recon_data.FastMriDataModule(dwi_root, "b50", device="cpu")
    assert (len(dm.train), len(dm.val), len(dm.test)) == (5, 5, 2)
    sizes = [2, 3]                   # the larger volume's slices first
    np.testing.assert_array_equal(dm.val_shards(1)[0],
                                  volume_affine_shards(sizes, 1)[0])
    jdm = jrd.FastMriDataModule(dwi_root, "b50")
    for n in (2, 3):
        got, want = dm.val_shards(n), jdm.val_shards(n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_h5_entries_name_h5py_without_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    (tmp_path / "train").mkdir()
    (tmp_path / "val").mkdir()
    with pytest.raises(ImportError, match="h5py"):
        recon_data.SliceDataset(tmp_path / "train", "b50", device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        train_varnet.main(["--data-path", str(tmp_path), "--device", "cpu"])
    with pytest.raises(ImportError, match="h5py"):
        evaluate.main(["--target-path", str(tmp_path / "train"),
                       "--predictions-path", str(tmp_path / "val"),
                       "--device", "cpu"])


def test_cli_train_varnet_train_then_test(dwi_root, tmp_path):
    """One epoch of a narrow b50 VarNet on the fixture, then ``--mode
    test``, which restores the run's snapshot (the JAX CLI validates fresh
    weights there: it resumes before its model exists) and exports one
    reconstruction a test volume."""
    flags = ["--data-path", str(dwi_root), "--out-dir", str(tmp_path),
             "--epochs", "1", "--num-cascades", "1", "--chans", "4",
             "--pools", "2", "--sens-chans", "4", "--sens-pools", "2",
             "--no-amp", "--device", "cpu"]
    assert train_varnet.main(flags) == 0
    assert (tmp_path / "varnet_best.ckpt").exists()
    args = json.loads((tmp_path / "varnet_best.ckpt.args.json").read_text())
    assert args["num_cascades"] == 1 and args["amp"] is False
    assert checkpoint.latest_resume_dir(str(tmp_path)).endswith(
        "resume_000001")
    out = tmp_path / "recons"
    assert train_varnet.main(flags + ["--mode", "test", "--recon-out",
                                      str(out)]) == 0
    import h5py
    with h5py.File(out / "case0.h5", "r") as hf:
        assert hf["reconstruction"].shape == (2, 200, 16)


@pytest.mark.parametrize("flag", [["--data-parallel", "2"],
                                  ["--coil-parallel", "2"],
                                  ["--pipeline-parallel", "2"],
                                  ["--ckpt-backend", "orbax"],
                                  ["--ckpt-async"]])
def test_cli_train_varnet_refusals(flag, tmp_path, capsys):
    """``--data-parallel`` / ``--coil-parallel`` / ``--pipeline-parallel``
    are taken now: they ask for their cards (none here; the grid runs on
    CPU ranks in ``tests/test_torch_varnet_shard.py``, the pipe in
    ``tests/test_torch_pipeline.py``); ``--ckpt-backend orbax`` is
    refused; ``--ckpt-async``, refused until the port wrote snapshots in
    the background, is taken and runs an epoch on the fixture."""
    if flag == ["--ckpt-async"]:
        pytest.importorskip("h5py")
        root = tmp_path / "dwi"
        for split in ("train", "val"):
            (root / split).mkdir(parents=True)
            write_dwi_h5(str(root / split / "case0.h5"), 1, slices=2)
        assert train_varnet.main([
            "--data-path", str(root), "--out-dir", str(tmp_path / "run"),
            "--epochs", "1", "--num-cascades", "1", "--chans", "4",
            "--pools", "2", "--sens-chans", "4", "--sens-pools", "2",
            "--no-amp", "--device", "cpu", *flag]) == 0
        assert checkpoint.latest_resume_dir(str(tmp_path / "run")).endswith(
            "resume_000001")
        return
    if flag[0] in ("--data-parallel", "--coil-parallel",
                   "--pipeline-parallel"):
        if not torch.cuda.is_available():
            with pytest.raises(ValueError,
                               match="requested 2 devices, have 0"):
                train_varnet.main(["--data-path", str(tmp_path), *flag])
        return
    with pytest.raises(SystemExit) as e:
        train_varnet.main(["--data-path", str(tmp_path), *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "orbax" in err


def test_cli_evaluate_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(9)
    for d in ("gt", "pred"):
        (tmp_path / d).mkdir()
    for i, acq in enumerate(("CORPD", "CORPDFS", "CORPD")):
        gt = rng.random((3, 24, 20)).astype(np.float32)
        with h5py.File(tmp_path / "gt" / f"f{i}.h5", "w") as hf:
            hf.create_dataset("reconstruction_rss", data=gt)
            hf.attrs["acquisition"] = acq
        with h5py.File(tmp_path / "pred" / f"f{i}.h5", "w") as hf:
            hf.create_dataset("reconstruction", data=(
                gt + 0.05 * rng.standard_normal(gt.shape)).astype(np.float32))
    for acq in (None, "CORPD"):
        ns = SimpleNamespace(target_path=tmp_path / "gt",
                             predictions_path=tmp_path / "pred",
                             acquisition=acq, acceleration=None,
                             device="cpu")
        got = evaluate.evaluate(ns, "reconstruction_rss")
        want = jevaluate.evaluate(ns, "reconstruction_rss")
        assert got.metrics["MSE"].n == want.metrics["MSE"].n == (
            3 if acq is None else 2)
        for k, v in want.means().items():
            assert got.means()[k] == pytest.approx(v, rel=1e-6)
    assert evaluate.main(["--target-path", str(tmp_path / "gt"),
                          "--predictions-path", str(tmp_path / "pred"),
                          "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_recon_runner_matches_jax(trainers, tmp_path):
    """The port's ``_ReconRunner`` on a port ``varnet_best.ckpt`` against
    the JAX one on the JAX checkpoint of the same weights. The JAX runner's
    forward is the JAX trainer's jitted one, already compiled at this shape
    by the validation test (the same function in the plain lowering:
    ``test_torch_varnet.py`` holds the lowerings equal)."""
    jt, tt, _ = trainers
    jckpt.save_best(str(tmp_path / "j.ckpt"), jt.params, {}, NARROW)
    checkpoint.save_best(str(tmp_path / "t.ckpt"), state_dict_from_flax_varnet(
        jax.tree_util.tree_map(np.asarray, jt.params)), NARROW)
    jr = jserve._ReconRunner(str(tmp_path / "j.ckpt"))
    jr.params, jr._fwd = jt.params, jt._fwd
    tr = serve._ReconRunner(str(tmp_path / "t.ckpt"), device="cpu")
    assert tr.model.aves == 1 and tr.model.sens_aves == 1
    s = jt.val_ds[:2]
    k, e = s[0].kspace, s[0].espirit
    got, want = tr.reconstruct(k, e)["recon"], jr.reconstruct(k, e)["recon"]
    assert got.shape == want.shape == (20, 16)
    assert np.abs(got - want).max() <= F32_RTOL * np.abs(want).max()
    two = tr.reconstruct(np.stack([x.kspace for x in s]),
                         np.stack([x.espirit for x in s]))["recon"]
    assert two.shape == (2, 20, 16)
    assert np.abs(two[0] - got).max() <= F32_RTOL * np.abs(got).max()
    assert (tr.requests, tr.slices) == (2, 3)
    for bad in (k[0], k[..., :1]):
        with pytest.raises(ValueError) as a:
            tr.reconstruct(bad, e)
        with pytest.raises(ValueError) as b:
            jr.reconstruct(bad, e)
        assert str(a.value) == str(b.value)


@pytest.fixture
def b50_ckpt(tmp_path):
    """A port ``varnet_best.ckpt`` of a narrow b50 VarNet (3 averages, maps
    with one), random weights."""
    args = {**NARROW, "bvalue": "b50"}
    model = init_fastmri_weights(tvt.build_varnet_from_args(args),
                                 torch.Generator().manual_seed(1))
    checkpoint.save_best(str(tmp_path / "b50.ckpt"), model.state_dict(),
                         args)
    return str(tmp_path / "b50.ckpt")


def _post(url, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=60) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return {k: z[k] for k in z.files}


def test_recon_daemon_serves_reconstruct(b50_ckpt):
    """A b50 checkpoint served: a 5-D and a batched 6-D request whose maps
    have one average, equal to the in-process runner; ``/metricsz`` counts
    2 requests and 3 slices; bad bodies answer 400, the segment route 404."""
    server = serve.create_server(SimpleNamespace(
        task="recon", ckpt=b50_ckpt, host="127.0.0.1", port=0,
        batch_size=4, warmup_shape="", device="cpu"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    runner = server.RequestHandlerClass.runner
    try:
        s = _samples(2, 13, aves=3)
        one = _post(url + "/v1/reconstruct", kspace=s[0].kspace,
                    espirit=s[0].espirit)["recon"]
        two = _post(url + "/v1/reconstruct",
                    kspace=np.stack([x.kspace for x in s]),
                    espirit=np.stack([x.espirit for x in s]))["recon"]
        with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
            text = r.read().decode()
        assert "serve_requests_total 2" in text
        assert "serve_slices_total 3" in text
        np.testing.assert_array_equal(one, runner.reconstruct(
            s[0].kspace, s[0].espirit)["recon"])
        assert two.shape == (2, 20, 16)
        # a batch of two computes each slice up to f32 rounding
        assert np.abs(two[0] - one).max() <= F32_RTOL * np.abs(one).max()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["task"] == "recon"
        for path, arrays, code in (
                ("/v1/reconstruct", {"kspace": s[0].kspace}, 400),
                ("/v1/reconstruct", {"kspace": s[0].kspace[0],
                                     "espirit": s[0].espirit}, 400),
                ("/v1/segment", {"img": np.zeros((1, 8, 8), np.float32)},
                 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + path, **arrays)
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        runner.close()
        thread.join(timeout=30)
    assert not thread.is_alive()
