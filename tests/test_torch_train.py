"""Parity of the PyTorch port's training path with the JAX package: losses,
metrics, the LR schedule, train-mode BatchNorm, the optimizer, the engine's
step / accumulation / validation, ``UNet2DArgs`` and a trainer run.

Models are small (ResNet18 encoder, decoder (32, 16, 16, 8, 8), 64x64,
batch 4) with seeded numpy weights converted by ``state_dict_from_flax``.
Tolerances, each stated where it is checked:
- loss values 1e-6 relative, their logit gradients 1e-5 * max|g|;
- metrics 1e-6; the schedule exactly equal;
- BatchNorm train mode: logits and running mean / var within 1e-5 of each
  tensor's max;
- optimizer: parameters within 1e-6 * max|p| per tensor after 3 steps;
- one engine step: loss 1e-5 relative, gradients 1e-4 * max|g| per tensor,
  BN stats 1e-5; three steps: losses 1e-3 relative, at most 0.1 % of
  parameter elements off by more than 1e-5 and none by more than
  2 * lr * steps (Adam's first steps move an element by about lr whatever
  its gradient's size, so a gradient that rounds to the other sign moves it
  the other way);
- validation: loss, Dice and IoU within 1e-5.
"""
import csv
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import NARROW, jax_variables

from mri_acl_imagesegmentation_adsp_tpu.data import hbm_loader as jhbm
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.models.norm import (
    BatchNorm as JaxBatchNorm)
from mri_acl_imagesegmentation_adsp_tpu.train import engine as jengine
from mri_acl_imagesegmentation_adsp_tpu.train import losses as jlosses
from mri_acl_imagesegmentation_adsp_tpu.train import metrics as jmetrics
from mri_acl_imagesegmentation_adsp_tpu.train import schedule as jschedule
from mri_acl_imagesegmentation_adsp_tpu.train import trainer as jtrainer
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import launcher
from mri_acl_imagesegmentation_adsp_tpu_torch.data import hbm_loader
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.norm import BatchNorm2d
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    losses, metrics, schedule, trainer)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    checkpoint as ckpt_lib)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
from mri_acl_imagesegmentation_adsp_tpu_torch.train.loggers import (
    NoOpLogger, make_logger)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
    make_optimizer)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

HW, BATCH, LR, WD = 64, 4, 1e-3, 1e-4
REPO = Path(__file__).resolve().parents[1]


def _close(got, want, rtol, name=""):
    """max |got - want| <= rtol * max |want| (+ 1e-12 for all-zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + 1e-12, (name, err)
    return err


# ---------------------------------------------------------------------------
# Losses and metrics
# ---------------------------------------------------------------------------

BINARY_NAMES = ["dice_bce", "bce_dice", "dice+bce", "focal", "tversky",
                "focal_tversky", "focal-tversky"]
MULTI_NAMES = ["dice_ce", "dice+ce", "ce_dice", "ce", "cross_entropy"]


def _loss_inputs(rng, classes, absent):
    logits = (2 * rng.standard_normal((4, classes, 16, 16))).astype(
        np.float32)
    if classes == 1:
        t = (rng.random((4, 1, 16, 16)) > 0.6).astype(np.float32)
        return logits, (np.zeros_like(t) if absent else t)
    t = rng.integers(0, classes, (4, 16, 16)).astype(np.int32)
    if absent:
        t[t == classes - 1] = 0      # the last class appears nowhere
    return logits, t


@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("classes,name",
                         [(1, n) for n in BINARY_NAMES]
                         + [(3, n) for n in MULTI_NAMES])
def test_loss_values_and_logit_grads_match_jax(rng, classes, name, absent):
    logits, targets = _loss_inputs(rng, classes, absent)
    jfn = jlosses.LossManager(classes=classes, name=name)
    tfn = losses.LossManager(classes=classes, name=name)
    want, jgrad = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(
        targets)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tfn(lt, torch.from_numpy(targets))
    got.backward()
    _close(float(got.detach()), float(want), 1e-6, "value")
    _close(lt.grad.numpy(), np.asarray(jgrad), 1e-5, "grad")


def test_loss_manager_from_config_and_unknown_names():
    cfg = {"classes": 1, "loss_name": "focal", "loss_weights": [0.3, 0.7],
           "focal_gamma": 3.0}
    got, want = losses.LossManager.from_config(cfg), \
        jlosses.LossManager.from_config(cfg)
    for f in ("classes", "name", "weights", "focal_alpha", "focal_gamma",
              "tversky_alpha", "tversky_beta", "tversky_gamma"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError):
        losses.LossManager(classes=1, name="ce")
    with pytest.raises(ValueError):
        losses.LossManager(classes=3, name="dice_bce")


def test_losses_stay_f32_on_bf16_logits(rng):
    logits, targets = _loss_inputs(rng, 1, False)
    lb = torch.from_numpy(logits).bfloat16()
    got = losses.LossManager()(lb, torch.from_numpy(targets))
    assert got.dtype == torch.float32
    want = jlosses.LossManager()(jnp.asarray(lb.float().numpy()),
                                 jnp.asarray(targets))
    _close(float(got), float(want), 1e-6)


def test_metrics_match_jax(rng):
    p = (rng.random((3, 1, 20, 20)) > 0.5).astype(np.float32)
    m = (rng.random((3, 1, 20, 20)) > 0.4).astype(np.float32)
    d, i = metrics.bin_dice_iou(torch.from_numpy(p), torch.from_numpy(m))
    jd, ji = jmetrics.bin_dice_iou(jnp.asarray(p), jnp.asarray(m))
    _close(float(d), float(jd), 1e-6)
    _close(float(i), float(ji), 1e-6)
    for fn, jfn in ((metrics.dice_bin, jmetrics.dice_bin),
                    (metrics.iou_bin, jmetrics.iou_bin)):
        for a, b in ((p[0, 0], m[0, 0]), (p[0, 0] * 0, m[0, 0] * 0)):
            _close(float(fn(torch.from_numpy(a), torch.from_numpy(b))),
                   float(jfn(jnp.asarray(a), jnp.asarray(b))), 1e-6)


def test_reduce_lr_on_plateau_matches_jax():
    vals = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8, 0.85]
    ours = schedule.ReduceLROnPlateau(lr=1e-3, factor=0.5, patience=3)
    theirs = jschedule.ReduceLROnPlateau(lr=1e-3, factor=0.5, patience=3)
    for v in vals:
        assert ours.step(v) == theirs.step(v)
        assert ours.state_dict() == theirs.state_dict()
    assert ours.lr < 1e-3
    fresh = schedule.ReduceLROnPlateau(lr=1.0)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.state_dict() == ours.state_dict()


# ---------------------------------------------------------------------------
# Model, BatchNorm and optimizer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The JAX model, its seeded variables, and the port's model loaded
    from them."""
    jm = jax_build("unet", "resnet18", "none", decoder_channels=NARROW)
    v = jax_variables(jm, HW)
    return jm, v


def _port_model(v):
    tm = build_unet("unet", "resnet18", decoder_channels=NARROW)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return tm


def _param_dict(tree, stats):
    """Flax tree -> {torch param name: numpy} (params only)."""
    sd = state_dict_from_flax(tree, stats)
    return {k: t.numpy() for k, t in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _stats_dict(stats, params):
    sd = state_dict_from_flax(params, stats)
    return {k: t.numpy() for k, t in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, HW, HW, 1)).astype(np.float32)
    yy, xx = np.mgrid[:HW, :HW]
    y = np.stack([((yy - 28 - i) ** 2 + (xx - 32) ** 2 < 240 + 40 * i)
                  for i in range(n)]).astype(np.int32)
    return x, y


def test_batchnorm_train_mode_matches_jax(small):
    """One train-mode forward: logits and the updated running stats. The
    port's BatchNorm folds the biased batch variance into running_var;
    ``nn.BatchNorm2d`` folds the unbiased one and fails this test."""
    jm, v = small
    x, _ = _batch(0)
    logits, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = _port_model(v).train()
    got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    _close(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(logits),
           1e-5, "logits")
    want = _stats_dict(upd["batch_stats"], v["params"])
    bufs = dict(tm.named_buffers())
    for name, w in want.items():
        _close(bufs[name].numpy(), w, 1e-5, name)


def test_batchnorm_bf16_matches_jax(rng):
    """Under bf16 (``amp``) the statistics stay f32 and the affine runs in
    bf16 with f32 weight and bias gradients, as the JAX module computes
    them: outputs and input gradients within one bf16 ulp (2^-7 of their
    max), running stats and weight / bias gradients within 1e-5."""
    x = (2 * rng.standard_normal((4, 6, 10, 10)) + 1).astype(np.float32)
    g = rng.standard_normal((4, 6, 10, 10)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    shift = rng.standard_normal(6).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1),
                     jnp.bfloat16)
    jbn = JaxBatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    v = jbn.init(jax.random.PRNGKey(0), xj)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
         "batch_stats": v["batch_stats"]}

    def f(params, xin):
        y, upd = jbn.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, xin,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32)
                       * jnp.asarray(g.transpose(0, 2, 3, 1))), (y, upd)
    (_, (jy, upd)), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], xj)

    bn = BatchNorm2d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(shift))
    xt = xb.clone().requires_grad_()
    y = bn(xt)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert bn.weight.grad.dtype == torch.float32
    _close(y.detach().float().numpy(), np.asarray(
        jy.astype(jnp.float32)).transpose(0, 3, 1, 2), 2 ** -7, "y")
    _close(xt.grad.float().numpy(), np.asarray(
        jgx.astype(jnp.float32)).transpose(0, 3, 1, 2), 2 ** -7, "dx")
    _close(bn.weight.grad.numpy(), np.asarray(jgp["scale"]), 1e-5, "dscale")
    _close(bn.bias.grad.numpy(), np.asarray(jgp["bias"]), 1e-5, "dbias")
    for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        _close(buf.numpy(), np.asarray(upd["batch_stats"][name]), 1e-5, name)


def _random_grads(params, seed, norm):
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params)
    scale = norm / float(optax.global_norm(g))
    return jax.tree.map(lambda t: (t * scale).astype(np.float32), g)


@pytest.mark.parametrize("norm", [20.0, 2.0], ids=["clip_fires",
                                                   "clip_idle"])
def test_optimizer_matches_optax(small, norm):
    """Three steps of clip + AdamW, the LR changed between steps 2 and 3."""
    _, v = small
    params = v["params"]
    tx = jengine.make_optimizer(LR, WD, 5.0)
    state = tx.init(params)
    names = list(_param_dict(params, v["batch_stats"]))
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()))
               for a in _param_dict(params, v["batch_stats"]).values()]
    opt = make_optimizer(tparams, LR, WD, 5.0)
    update = jax.jit(tx.update)
    for i in range(3):
        if i == 2:
            state = jengine.set_lr(state, LR / 2)
            opt.lr = LR / 2
        g = _random_grads(params, i, norm)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        gd = _param_dict(g, v["batch_stats"])
        opt.step([torch.from_numpy(gd[n]) for n in names])
    want = _param_dict(params, v["batch_stats"])
    for n, p in zip(names, tparams):
        _close(p.detach().numpy(), want[n], 1e-6, n)
    assert opt.count == 3 and jengine.get_lr(state) == pytest.approx(LR / 2)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _engines(small, accum_steps=1):
    jm, v = small
    tx = jengine.make_optimizer(LR, WD, 5.0)
    jeng = jengine.Engine(jm, jlosses.LossManager(), tx, aug="none",
                          donate=False, accum_steps=accum_steps)
    state = jengine.TrainState(v["params"], v["batch_stats"],
                               tx.init(v["params"]), jnp.int32(0))
    tm = _port_model(v)
    eng = Engine(tm, losses.LossManager(),
                 make_optimizer(tm.parameters(), LR, WD, 5.0), aug="none",
                 accum_steps=accum_steps)
    return jeng, state, eng


def _stores(n):
    x, y = _batch(7, n)
    src = (x[..., 0], y, np.array([0, n // 2]), np.array([n // 2,
                                                          n - n // 2]), [])
    return (jhbm.SliceStore(*src).to_device(k=1),
            hbm_loader.SliceStore(*src).to_device(1, device="cpu"))


def test_engine_step_matches_jax(small):
    jeng, state, eng = _engines(small)
    x, y = _batch(1)
    loss, grads, new_bs = jax.jit(jeng._grads_one)(
        state.params, state.batch_stats, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    tl, tg = eng.grads_one(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                           torch.from_numpy(y.astype(np.uint8)), None)
    _close(float(tl), float(loss), 1e-5, "loss")
    want = _param_dict(grads, state.batch_stats)
    names = [n for n, _ in eng.model.named_parameters()]
    assert len(names) == len(want) == len(tg)
    for n, g in zip(names, tg):
        _close(g.numpy(), want[n], 1e-4, n)
    bufs = dict(eng.model.named_buffers())
    for n, w in _stats_dict(new_bs, state.params).items():
        _close(bufs[n].numpy(), w, 1e-5, n)


def _jax_steps(jeng, state, perm):
    jstore, _ = _stores(12)
    keys = jax.random.split(jax.random.PRNGKey(0), perm.shape[0])
    return jeng._train_steps_c(state, jstore.images, jstore.masks,
                               jstore.neighbors, jnp.asarray(perm), keys,
                               batch_size=perm.shape[1])


def _share_off(got, want):
    """(share of elements off by more than 1e-5, largest difference)."""
    d = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    return float((d > 1e-5).mean()), float(d.max())


def _check_steps(small, perm, accum):
    """Steps of the port against the JAX engine. The share of parameter
    elements off by more than 1e-5 is held to the share by which the JAX
    package's own two decoder lowerings (fused phase-space and plain, equal
    in exact arithmetic) disagree on the same steps: Adam divides each
    element's moment by its own root mean square, so a gradient element
    with a few ulps of relative error moves by a visible share of lr."""
    jeng, state, eng = _engines(small, accum)
    new, jl = _jax_steps(jeng, state, perm)
    _, store = _stores(12)
    tl = eng.train_steps(store, torch.from_numpy(perm).long(), None)
    _close(tl.numpy(), np.asarray(jl), 1e-3, "losses")
    steps = perm.shape[0] // accum
    assert eng.step == int(new.step) == steps
    want = _param_dict(new.params, new.batch_stats)
    got = {n: p.detach().numpy() for n, p in eng.model.named_parameters()}
    share, worst = _share_off(got, want)

    jm, v = small
    plain = jax_build("unet", "resnet18", "none", decoder_channels=NARROW,
                      fused_decoder=False)
    pjeng = jengine.Engine(plain, jlosses.LossManager(), jeng.tx,
                           aug="none", donate=False, accum_steps=accum)
    pnew, _ = _jax_steps(pjeng, state, perm)
    jax_share, _ = _share_off(_param_dict(pnew.params, pnew.batch_stats),
                              want)
    assert share <= max(1e-3, jax_share), (share, jax_share)
    assert worst <= 2 * LR * steps, worst


def test_engine_three_steps_match_jax(small):
    perm = np.array([[0, 5, 9, 2], [11, 3, 6, 1], [4, 8, 10, 7]], np.int32)
    _check_steps(small, perm, 1)


def test_engine_accumulation_matches_jax(small):
    perm = np.array([[0, 5, 9, 2], [11, 3, 6, 1], [4, 8, 10, 7],
                     [1, 2, 3, 4]], np.int32)
    _check_steps(small, perm, 2)


def test_validate_matches_jax_with_a_remainder_batch(small):
    jeng, state, eng = _engines(small)
    jstore, store = _stores(10)
    want = jeng.validate(state, jstore, BATCH)
    got = eng.validate(store, BATCH)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    probs = eng.predict_probs(store.images[:2, None].float())
    jprobs = jeng.predict_probs(state, jstore.images[:2, :, :, None])
    _close(probs.numpy(), jprobs, 1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_non_finite_guard_names_the_step(accum):
    losses_dev = np.array([0.5, 0.4, np.nan, 0.3], np.float32)
    msgs = []
    for fn, arr, step in ((jengine.Engine.check_epoch_losses,
                           jnp.asarray(losses_dev), SimpleNamespace(step=10)),
                          (Engine.check_epoch_losses,
                           torch.from_numpy(losses_dev), 10)):
        with pytest.raises(RuntimeError) as e:
            fn(arr, step, accum)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "step" in msgs[0]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_unet2d_args_are_the_jax_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(
        trainer.UNet2DArgs)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(
        jtrainer.UNet2DArgs)]
    assert ours == theirs


def test_committed_args_json_files_replay():
    b8 = json.loads((REPO / "runs/corpus_scale_b8/args.json").read_text())
    b128 = json.loads((REPO / "runs/corpus_scale/args.json").read_text())
    args = trainer.UNet2DArgs(**b8)
    assert dataclasses.asdict(args) == b8
    trainer.check_args(args)          # the b8 run is what the port trains
    args = trainer.UNet2DArgs(**b128)
    assert dataclasses.asdict(args) == b128
    with pytest.raises(ValueError, match="--ckpt-backend"):
        trainer.check_args(args)      # orbax is a JAX library
    # its async snapshots run, in the port's own format
    trainer.check_args(dataclasses.replace(args, ckpt_backend="msgpack"))


@pytest.mark.parametrize("field,value", [
    ("store_dtype", "float16"), ("ckpt_async", True),
    ("ckpt_backend", "orbax"),
    ("save_resume_every", -1), ("save_resume_steps", -5),
    ("resume_keep", -2), ("profile_epochs", -1),
    ("encoder_weights", "/nonexistent/resnet.pt"),
    ("encoder_weights", "imagenet"), ("data_parallel", 0)])
def test_refused_extensions_raise_naming_the_flag(tmp_path, field, value):
    """Each refused setting raises naming its flag and writes nothing;
    ``ckpt_async``, refused until the port had its own background writer,
    is accepted and runs (a launcher epoch publishing its snapshot)."""
    if field == "ckpt_async":
        _packs(tmp_path / "art")
        assert _launch(tmp_path, "--no-amp", "--ckpt-async",
                       "--save-resume-every", "1") == 0
        assert ckpt_lib.latest_resume_dir(str(tmp_path / "run")).endswith(
            "resume_000001")
        assert not any(p.name.endswith(".tmp") for p in (
            tmp_path / "run" / "checkpoints").iterdir())
        return
    args = trainer.UNet2DArgs(out_dir=str(tmp_path / "run"), **{field: value})
    with pytest.raises(ValueError, match="--" + field.replace("_", "-")):
        trainer.UNet2DTrainer(args, device="cpu")
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("field,value", [
    ("data_parallel", 2), ("multihost", True), ("store_sharded", True),
    ("data_parallel", 4)])
def test_parallel_extensions_of_the_trainer(tmp_path, monkeypatch, field,
                                            value):
    """What the data-parallel flags do in one process (the ranks
    themselves run in ``test_torch_parallel_*.py``): ``data_parallel``
    above 1 needs a group of that many ranks, which ``cli.launcher``
    spawns; ``multihost`` without torchrun's environment trains on one
    rank, as JAX's ``distributed_init`` is a no-op there; ``store_sharded``
    keeps a rank's share of the store padded to the world."""
    args = trainer.UNet2DArgs(out_dir=str(tmp_path / "run"), **{field: value})
    cpu = torch.device("cpu")
    if field == "data_parallel":
        with pytest.raises(ValueError, match=f"--data-parallel {value} "
                           "trains on that many ranks: start them with "
                           "cli.launcher"):
            trainer.UNet2DTrainer(args, device="cpu")
        assert not (tmp_path / "run").exists()
        with pytest.raises(ValueError, match=f"--data-parallel {value} on "
                           "a group of 3 ranks"):
            trainer._rank_group(args, cpu, SimpleNamespace(world=3))
        group = SimpleNamespace(world=value)
        assert trainer._rank_group(args, cpu, group) is group
    elif field == "multihost":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert trainer._rank_group(args, cpu, None) is None
    else:
        x, y = _batch(3, 5)
        src = hbm_loader.SliceStore(x[..., 0], y, np.array([0, 2]),
                                    np.array([2, 3]), [])
        for rank, rows in ((0, [0, 1, 2]), (1, [3, 4, 4])):
            st = src.to_device(3, device="cpu", shard=args.store_sharded,
                               group=SimpleNamespace(world=2, rank=rank))
            assert st.sharded and st.row0 == rows[0] and st.num_slices == 5
            np.testing.assert_array_equal(st.images.numpy(), x[rows, ..., 0])
            np.testing.assert_array_equal(st.neighbors.numpy(),
                                          src.neighbor_table(3))


def test_loggers(tmp_path):
    assert isinstance(make_logger("noop", "/nonexistent"), NoOpLogger)
    for kind in ("tb", "csv+tb"):         # TensorBoard event files
        lg = make_logger(kind, str(tmp_path / kind))
        lg.log_epoch(epoch=1, time_s=1.0, train_loss=0.5, val_loss=0.4,
                     val_dice=0.6, val_iou=0.5, lr=1e-3)
        lg.close()
        assert list((tmp_path / kind / "tb").glob("events.out.tfevents.*"))
        assert ((tmp_path / kind / "history_epoch.csv").is_file()
                == (kind == "csv+tb"))
    with pytest.raises(ValueError):
        make_logger("wandb", "/nonexistent")


def _packs(root, nan=False):
    pre = MRIKneePreprocessor(out_size=(HW, HW), device="cpu")
    for i in range(4):
        pair = synthetic_kspace_pairs(seed=i, s=10, h=64, w=48)
        pack_kspace_volume(pre, pair, str(root / f"vol{i}"))
        if nan:
            z = dict(np.load(root / f"vol{i}" / "volume.npz"))
            z["img"][:] = np.nan
            np.savez(root / f"vol{i}" / "volume.npz", **z)


def _launch(tmp_path, *extra):
    return launcher.main([
        "--skip-preprocess", "--artifact-dir", str(tmp_path / "art"),
        "--list-dir", str(tmp_path / "lists"),
        "--out-dir", str(tmp_path / "run"), "--epochs", "1",
        "--batch-size", "4", "--encoder", "resnet18", "--device", "cpu",
        *extra])


def _csv_header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_trainer_run_writes_the_reference_run_layout(tmp_path):
    _packs(tmp_path / "art")
    assert _launch(tmp_path, "--no-amp", "--save-val-probs") == 0
    run, ref = tmp_path / "run", REPO / "runs/corpus_scale_b8"
    names = {p.name for p in run.iterdir()}
    want = {p.name for p in ref.iterdir()} - {"MISSING_LARGE_BLOBS.txt"}
    assert names == want | {"best.ckpt", "val_preds.npz"}
    with np.load(run / "val_preds.npz") as z:
        assert z["probs"].shape == z["gts"].shape == (4, 1, HW, HW)
    assert sorted(p.name for p in (run / "samples").iterdir()) == [
        f"sample_{i:04d}.png" for i in range(4)]
    for name in ("history_epoch.csv", "history_step.csv"):
        assert _csv_header(run / name) == _csv_header(ref / name)
    for name in ("args.json", "metrics.json", "best.ckpt.args.json"):
        got, want = (json.loads((d / name).read_text()) for d in (run, ref))
        assert got.keys() == want.keys(), name
    got, want = (json.loads((d / "summary.json").read_text())
                 for d in (run, ref))
    assert got.keys() == want.keys()
    assert got["best"].keys() == want["best"].keys()
    hist, ref_hist = (json.loads((d / "history.json").read_text())
                      for d in (run, ref))
    assert len(hist) == 1 and hist[0].keys() == ref_hist[0].keys()
    with open(run / "history_step.csv") as f:
        steps = list(csv.DictReader(f))
    assert len(steps) == 3 and all(np.isfinite(float(r["train_loss_step"]))
                                   for r in steps)


def test_trainer_run_raises_naming_the_step_of_a_nan_loss(tmp_path):
    _packs(tmp_path / "art", nan=True)
    with pytest.raises(RuntimeError, match="Non-finite loss at step 0"):
        _launch(tmp_path, "--amp")
