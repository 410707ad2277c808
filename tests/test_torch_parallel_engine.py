"""Data parallelism, part 2: the engine's data-parallel step, validation
and volume-affine sharded validation on two gloo ranks, against the same
work on one process and against the JAX engine on a 2-device mesh of the
repo's virtual CPU devices, from the same weights (``models/convert.py``).

One spawn runs every configuration on its two ranks (the narrow U-Net:
ResNet18 encoder, decoder (32, 16, 16, 8, 8), 32x32, batch 4 = 2 a rank):
- float64, light augmentation, dice_bce, BN in train mode, 2.5-D k = 3,
  three steps, with the store replicated and row-sharded; four steps at
  ``accum_steps`` 2; a batch of 3 that two ranks do not divide (the
  replicated fallback); and the first step again with the ranks'
  gradients summed instead of averaged (the fault the mutation test puts
  back). float64 makes the comparison sharp: reassociation cannot move
  Adam's first steps, which move an element by about lr whatever the size
  of its gradient;
- f32, no augmentation, k = 1, from JAX's weights, against the JAX engine
  on a ("data",) mesh of 2 devices with a row-sharded store.

Tolerances, each stated where it is checked:
- 2 ranks against 1 (float64): step losses within 1e-6 relative;
  parameters and BN running statistics within 1e-5 of each tensor's max;
  the first step's gradients within 1e-9 of each tensor's max; the two
  ranks' parameters bit-equal; summed gradients are off by a factor 2
  (more than 0.5 of the max);
- 2 ranks against the JAX engine on 2 devices (f32): the tolerances
  ``tests/test_torch_train.py`` holds one rank to: losses within 1e-3
  relative, the share of parameter elements off by more than 1e-5 at most
  0.1 % or the share by which JAX's own 2-device and 1-device runs
  disagree, and none off by more than 2 * lr * steps; validation loss,
  Dice and IoU within 1e-5; per-volume Dice of the volume-sharded validation within
  1e-6 (f32 per-slice Dice);
- the volume-sharded validation on 2 ranks: per-volume Dice equal to one
  rank's, and to the means of the unsharded per-slice Dice within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_parallel_ranks as ranks
from test_torch_model import jax_variables

from mri_acl_imagesegmentation_adsp_tpu.data import hbm_loader as jhbm
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.train import engine as jengine
from mri_acl_imagesegmentation_adsp_tpu.train import losses as jlosses
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh

HW = 32
PERM3 = [[0, 5, 9, 2], [11, 3, 6, 1], [4, 8, 10, 7]]
VOLS = {"vol_sizes": [5, 7], "n_shards": 2}
CFGS = {
    "replicated": dict(f64=True, aug="light", k=3, perm=PERM3, **VOLS),
    "sharded": dict(f64=True, aug="light", k=3, perm=PERM3, shard=True,
                    **VOLS),
    "accum": dict(f64=True, aug="light", k=3, accum=2, shard=True,
                  perm=PERM3 + [[1, 2, 3, 4]], validate=False),
    "fallback": dict(f64=True, aug="light", k=3, validate=False,
                     perm=[[0, 5, 9], [11, 3, 6], [4, 8, 10]]),
    "summed": dict(f64=True, aug="light", k=3, perm=PERM3[:1],
                   fault="summed", grads_only=True),
}
# one process: the store's sharding is a rank's matter, so "sharded" is
# held to the replicated store's one-process run
ONE_RANK = {"replicated": "replicated", "sharded": "replicated",
            "accum": "accum", "fallback": "fallback"}


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
    return err


@pytest.fixture(scope="module")
def jax_setup():
    jm = jax_build("unet", "resnet18", "none", decoder_channels=ranks.NARROW)
    v = jax_variables(jm, HW)
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    cfg = dict(aug="none", k=1, perm=PERM3, shard=True, **VOLS,
               state_dict={k: t.numpy() for k, t in sd.items()})
    return jm, v, cfg


@pytest.fixture(scope="module")
def two_ranks(jax_setup):
    cfgs = list(CFGS.values()) + [jax_setup[2]]
    out = mesh.spawn(ranks.engine_rank, 2, ["cpu", "cpu"], args=(cfgs,),
                     threads=1, timeout_s=600)
    return {name: [out[r][i] for r in range(2)]
            for i, name in enumerate(list(CFGS) + ["jax"])}


@pytest.fixture(scope="module")
def one_rank():
    runs = {name: ranks.engine_run(CFGS[name])
            for name in set(ONE_RANK.values())}
    return {name: runs[ref] for name, ref in ONE_RANK.items()}


@pytest.mark.parametrize("name", ["replicated", "sharded", "accum",
                                  "fallback"])
def test_two_ranks_step_as_one(two_ranks, one_rank, name):
    want = {k: v for k, v in one_rank[name].items()}
    for got in two_ranks[name]:
        _close(got["losses"], want["losses"].numpy(), 1e-6, "losses")
        for part in ("params", "stats"):
            for n, w in want[part].items():
                _close(got[part][n], w.numpy(), 1e-5, n)
        for n, w in want["grads_one"].items():
            _close(got["grads_one"][n], w.numpy(), 1e-9, n)
        if "validate" in want:
            np.testing.assert_allclose(got["validate"],
                                       want["validate"].numpy(), rtol=1e-9)
    a, b = two_ranks[name]
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n])
    assert len(a["losses"]) == len(CFGS[name]["perm"])


def test_summed_gradients_fail_the_gate(one_rank, two_ranks):
    """The mutation: ranks that sum their gradients instead of averaging
    them take twice the global batch's gradient."""
    want = one_rank["replicated"]["grads_one"]
    for got in two_ranks["summed"]:
        worst = max(np.abs(got["grads_one"][n] - w.numpy()).max()
                    / np.abs(w.numpy()).max()
                    for n, w in want.items() if n != "loss")
        assert worst > 0.5, worst


def test_volume_sharded_validation_is_by_slice(two_ranks, one_rank):
    """Whole volumes on each rank, duplicates dropped: the per-volume Dice
    are the means of the unsharded per-slice Dice, and equal one rank's
    two shards run in turn."""
    want = one_rank["replicated"]
    per_slice = want["per_slice"].numpy()[:, 0].astype(np.float64)
    vol_of = np.repeat([0, 1], VOLS["vol_sizes"])
    by_vol = np.asarray([per_slice[vol_of == v].mean() for v in (0, 1)])
    for name in ("replicated", "sharded"):
        for got in two_ranks[name]:
            vs = got["volume_sharded"]
            np.testing.assert_allclose(vs["per_vol"], by_vol, rtol=1e-12)
            np.testing.assert_array_equal(
                vs["per_vol"], want["volume_sharded"]["per_vol"])
            assert vs["dice"] == pytest.approx(by_vol.mean(), rel=1e-12)


@pytest.mark.parametrize("name", ["replicated", "sharded"])
def test_volume_sharded_validation_splits_the_forward(two_ranks, one_rank,
                                                      name):
    """Each of two ranks runs the model on its own shard's rows only, half
    of what one process scoring both shards runs, with the store
    replicated or row-sharded (where every rank gathers every shard's
    batch)."""
    alone = one_rank["replicated"]["volume_sharded"]["rows_forwarded"]
    for got in two_ranks[name]:
        assert 2 * got["volume_sharded"]["rows_forwarded"] == alone


# ---------------------------------------------------------------------------
# Against the JAX engine on a 2-device mesh
# ---------------------------------------------------------------------------

def _share_off(got, want):
    """(share of parameter elements off by more than 1e-5, the largest
    difference)."""
    d = np.concatenate([np.abs(got[n] - w).ravel() for n, w in want.items()])
    return float((d > 1e-5).mean()), float(d.max())


def _params(state):
    return {k: t.numpy() for k, t in state_dict_from_flax(
        state.params, state.batch_stats).items()
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def _jax_run(jm, v, devices=2):
    """Three JAX engine steps (aug none) on a ("data",) mesh of ``devices``
    devices (the store row-sharded), or on one device without a mesh."""
    m = (Mesh(np.asarray(jax.devices()[:devices]), ("data",))
         if devices > 1 else None)
    x, y = ranks.seg_batch(12, HW)
    src = jhbm.SliceStore(x, y, np.array([0, 6]), np.array([6, 6]), [])
    store = src.to_device(k=1, mesh=m, shard=m is not None)
    tx = jengine.make_optimizer(ranks.LR, ranks.WD, 5.0)
    eng = jengine.Engine(jm, jlosses.LossManager(), tx, aug="none",
                         donate=False, mesh=m)
    state = jengine.TrainState(v["params"], v["batch_stats"],
                               tx.init(v["params"]), jnp.int32(0))
    if m is not None:
        state = jax.device_put(state, NamedSharding(m, P()))
    perm = jnp.asarray(np.asarray(PERM3, np.int32))
    keys = jax.random.split(jax.random.PRNGKey(0), perm.shape[0])
    new, losses = eng._train_steps_c(state, store.images, store.masks,
                                     store.neighbors, perm, keys,
                                     batch_size=4)
    return (eng, state, store, new, np.asarray(losses))


def test_two_ranks_match_the_jax_engine_on_two_devices(jax_setup,
                                                       two_ranks):
    """The share of parameter elements off by more than 1e-5 is held, as in
    ``tests/test_torch_train.py``, to the share by which the JAX package
    disagrees with itself on the same steps: here its 2-device and its
    1-device runs (equal in exact arithmetic; about a third of the
    elements at this size). Adam moves each element by about lr whatever
    its gradient's size, so an element whose gradient is a few ulps from
    zero moves either way."""
    jm, v, _ = jax_setup
    eng, state, store, new, jl = _jax_run(jm, v)
    want = _params(new)
    jax_share, _ = _share_off(_params(_jax_run(jm, v, devices=1)[3]), want)
    jval = eng.validate(state, store, 4)
    jvs = eng.validate_volume_sharded(state, store, VOLS["vol_sizes"], 2, 4)
    for got in two_ranks["jax"]:
        _close(got["losses"], jl, 1e-3, "losses")
        share, worst = _share_off(got["params"], want)
        assert share <= max(1e-3, jax_share), (share, jax_share)
        assert worst <= 2 * ranks.LR * len(PERM3), worst
        for g, w in zip(got["validate"], jval):
            assert abs(g - w) <= 1e-5, (got["validate"], jval)
        vs = got["volume_sharded"]
        np.testing.assert_allclose(vs["per_vol"], jvs[2], rtol=1e-6)
        assert vs["dice"] == pytest.approx(jvs[0], rel=1e-6)
        assert vs["iou"] == pytest.approx(jvs[1], rel=1e-6)
