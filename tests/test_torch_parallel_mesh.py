"""Data parallelism, part 1: the port's ``parallel/mesh.py`` against the JAX
package's (``volume_affine_shards``, ``host_major_grid``, the
``divisible_spec`` rule on the batch axis, ``distributed_init``), the
collectives, the synced BatchNorm and the batch-global loss sums on two
gloo ranks against one process, their mutations, data-parallel inference,
and the heavy (elastic) augmentation recipe against JAX's.

Tolerances, each stated where it is checked:
- shards, grids and row assignments: exactly equal;
- the collectives: exact (sums of small integers; a gather is one
  non-zero addend an element);
- BatchNorm in float64 on 2 ranks x 4 rows against 8 rows on one process:
  outputs, input and affine gradients and running statistics within
  1e-12 of each tensor's max; with each rank's own statistics (the fault)
  the outputs are off by more than 1e-3;
- the losses in float64: the mean over the ranks of the rank losses within
  1e-12 relative of the one-process loss, each rank's logit gradient times
  the world within 1e-12 of the max; with each rank's own Dice / Tversky
  sums (the fault) the loss is off by more than 1e-6 relative, a million
  times the gate;
- data-parallel inference on two CPU replicas: masks bit-equal, and
  probabilities equal, to one device's, for 7 slices at batch 4;
- the elastic warp with JAX's field and parameters against JAX's
  ``augment_batch``: images within 1e-4, masks equal on all but 0.5 % of
  pixels (a source position on a pixel edge rounds either way in f32);
  the port's field and JAX's: standard deviation 20/3 px within 1e-4
  relative, neighbour correlation above 0.97 and within 0.02 of each
  other's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_parallel_ranks as ranks
from mri_acl_imagesegmentation_adsp_tpu.parallel import mesh as jmesh
from mri_acl_imagesegmentation_adsp_tpu.train import augment as jaug
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    ReplicatedApply, segment_volume_2d, threshold_probs)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.train import augment


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
    assert err <= rtol * np.abs(want).max() + 1e-300, (name, err)
    return err


# ---------------------------------------------------------------------------
# Numpy copies against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,n_shards", [
    ([10, 7, 12, 3, 9], 2), ([10, 7, 12, 3, 9], 4), ([5], 3),
    ([4, 4, 4, 4], 4), ([1, 30, 2], 2)])
def test_volume_affine_shards_equal_jax(sizes, n_shards):
    got = mesh.volume_affine_shards(sizes, n_shards)
    want = jmesh.volume_affine_shards(sizes, n_shards)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_host_major_grid_equals_jax():
    devs = [SimpleNamespace(process_index=pi, id=i) for pi, i in
            [(2, 1), (0, 0), (1, 1), (0, 1), (2, 0), (1, 0)]]
    got, want = mesh.host_major_grid(devs, 3), jmesh.host_major_grid(devs, 3)
    assert got.shape == want.shape == (3, 2)
    assert [d for d in got.ravel()] == [d for d in want.ravel()]
    uneven = devs[:5] + [SimpleNamespace(process_index=0, id=2)]
    for bad, hosts in ((devs, 4), (uneven, 3)):
        with pytest.raises(ValueError) as mine:
            mesh.host_major_grid(bad, hosts)
        with pytest.raises(ValueError) as theirs:
            jmesh.host_major_grid(bad, hosts)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("batch", [8, 7, 6, 4, 1])
@pytest.mark.parametrize("world", [2, 4])
def test_row_sharding_is_jax_divisible_spec(batch, world):
    """The rows a rank holds are the rows JAX's ``divisible_spec`` places
    on that device of a ``world``-device mesh; a batch the world does not
    divide is whole on every rank."""
    m = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    spec = jmesh.divisible_spec(m, (batch, 3), P("data", None))
    x = np.arange(batch * 3, dtype=np.float32).reshape(batch, 3)
    placed = jax.device_put(x, NamedSharding(m, spec))
    by_dev = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, d in enumerate(m.devices.ravel()):
        group = SimpleNamespace(world=world, rank=r)
        assert (mesh.row_slice(batch, group) is None) == (spec[0] is None)
        got = mesh.shard_rows(torch.from_numpy(x), group).numpy()
        np.testing.assert_array_equal(got, by_dev[d])


def test_distributed_init_is_gated_as_jax(monkeypatch):
    """World 1 (no torchrun environment): no group, as JAX's
    ``distributed_init`` returns False without ``JAX_NUM_PROCESSES``."""
    for var in ("WORLD_SIZE", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.distributed_init("cpu") is False
    assert jmesh.distributed_init() is False
    assert mesh.env_group("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.distributed_init("cpu") is False


def test_mesh_devices_raise_as_jax_make_mesh():
    assert mesh.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError,
                       match=f"requested {have + 1} devices, have {have}"):
        mesh.mesh_devices(have + 1, "cuda")
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        jmesh.make_mesh(9)
    assert mesh.choose_backend(["cpu", "cpu"]) == "gloo"
    assert mesh.choose_backend(["cuda:0", "cuda:0"]) == "gloo"


# ---------------------------------------------------------------------------
# Two gloo ranks: collectives, BatchNorm, losses (one spawn)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    return mesh.spawn(ranks.collectives_rank, 2, ["cpu", "cpu"], threads=1,
                      timeout_s=300)


def test_collectives_are_exact(two_ranks):
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(two_ranks):
        assert out["rows"] == [4 * r, 4 * r + 4]
        # 1 * 2 + 2 * 3 summed forward; the backward sums both ranks'
        # upstream ones, times this rank's factor
        np.testing.assert_array_equal(out["sum_fwd"], [8.0] * 3)
        np.testing.assert_array_equal(out["sum_grad"], [2.0 * (r + 2)] * 3)
        np.testing.assert_array_equal(out["gathered"], full)
        np.testing.assert_array_equal(out["kept"], full[:7])
        assert out["any"] == [True, False]


def test_synced_batchnorm_is_the_global_batch(two_ranks):
    want = ranks.bn_step(*ranks.bn_inputs())
    want = {k: v.numpy() for k, v in want.items()}
    for r, out in enumerate(two_ranks):
        got = out["bn"]
        rows = slice(4 * r, 4 * r + 4)
        for key in ("y", "dx"):
            _close(got[key], want[key][rows], 1e-12, key)
        for key in ("mean", "var"):
            _close(got[key], want[key], 1e-12, key)
        # each rank's affine gradients are its rows' share of the sum
    for key in ("dw", "db"):
        _close(two_ranks[0]["bn"][key] + two_ranks[1]["bn"][key],
               want[key], 1e-12, key)


def test_per_rank_batchnorm_statistics_fail_the_gate(two_ranks):
    """The mutation: each rank normalizing with its own rows' statistics
    is caught by the outputs and the running statistics."""
    want = {k: v.numpy() for k, v in ranks.bn_step(
        *ranks.bn_inputs()).items()}
    for r, out in enumerate(two_ranks):
        rows = slice(4 * r, 4 * r + 4)
        err = np.abs(out["bn_local"]["y"] - want["y"][rows]).max()
        assert err > 1e-3 * np.abs(want["y"]).max(), err
        assert np.abs(out["bn_local"]["mean"] - want["mean"]).max() > 1e-3


@pytest.mark.parametrize("name,classes", ranks.LOSS_KINDS)
def test_batch_global_loss_sums(two_ranks, name, classes):
    want = {k: v.numpy() for k, v in ranks.loss_step(name, classes).items()}
    mean = np.mean([float(o["loss"][name]["loss"]) for o in two_ranks])
    assert abs(mean - float(want["loss"])) <= 1e-12 * abs(
        float(want["loss"])), (mean, want["loss"])
    for r, out in enumerate(two_ranks):
        rows = slice(4 * r, 4 * r + 4)
        _close(out["loss"][name]["grad"] / 2, want["grad"][rows], 1e-12,
               name)


@pytest.mark.parametrize("name,classes", ranks.LOSS_KINDS)
def test_per_rank_dice_sums_fail_the_gate(two_ranks, name, classes):
    """The mutation: each rank's Dice / Tversky ratio of its own rows'
    sums is not the global batch's loss."""
    want = float(ranks.loss_step(name, classes)["loss"])
    mean = np.mean([float(o["loss_local"][name]["loss"])
                    for o in two_ranks])
    assert abs(mean - want) > 1e-6 * abs(want), (mean, want)


# ---------------------------------------------------------------------------
# Data-parallel inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tta", ["none", "hflip"])
def test_replicated_inference_equals_one_device(tta):
    """7 slices at batch 4 on two CPU replicas: the batch rounds to 4 (2 a
    replica), the stack pads to 8 with the last slice, and the masks are
    the one-device masks bit for bit."""
    model = init_weights(build_unet("unet", "resnet18", in_ch=3, classes=1,
                                    decoder_channels=ranks.NARROW),
                         torch.Generator().manual_seed(4)).eval()
    twin = init_weights(build_unet("unet", "resnet18", in_ch=3, classes=1,
                                   decoder_channels=ranks.NARROW),
                        torch.Generator().manual_seed(4)).eval()
    vol = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (7, 1, 32, 32)).astype(np.float32))
    calls = []

    def counted(m):
        def fn(x):
            calls.append(x.shape[0])
            return m(x)
        return fn
    dp = ReplicatedApply([counted(model), counted(twin)],
                         ["cpu", "cpu"])
    want = segment_volume_2d(model, vol, k=3, batch_size=4, tta=tta)
    got = segment_volume_2d(dp, vol, k=3, batch_size=4, tta=tta)
    assert got.shape == want.shape == (7, 1, 32, 32)
    assert set(calls) == {2} and len(calls) == 4 * (2 if tta == "hflip"
                                                    else 1)
    np.testing.assert_array_equal(threshold_probs(got, 1, 0.5).numpy(),
                                  threshold_probs(want, 1, 0.5).numpy())
    _close(got.numpy(), want.numpy(), 1e-6)
    with pytest.raises(ValueError, match="does not split"):
        dp(torch.zeros((3, 3, 32, 32)))


# ---------------------------------------------------------------------------
# The heavy (elastic) recipe
# ---------------------------------------------------------------------------

def _jax_heavy(x, y, seed):
    key = jax.random.PRNGKey(seed)
    p = jaug.sample_params(key, x.shape[0], "heavy")
    xo, yo = jaug.augment_batch(jnp.asarray(x), jnp.asarray(y), key,
                                "heavy")
    h, w = x.shape[1:3]
    fields = np.stack([np.stack([np.asarray(f) for f in jaug._elastic_field(
        s, h, w)]) for s in np.asarray(p.elastic_seed)])
    return p, np.asarray(xo), np.asarray(yo), fields


@pytest.mark.parametrize("seed", [0, 3])
def test_elastic_warp_equals_jax_with_its_field(rng, seed):
    b, h, w, c = 6, 40, 36, 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    y = np.stack([((yy - 18 - i) ** 2 + (xx - 17) ** 2 < 120)
                  for i in range(b)]).astype(np.uint8)
    p, xj, yj, fields = _jax_heavy(x, y, seed)
    assert np.asarray(p.apply_elastic).any()
    tp = augment.AugParams(*(torch.from_numpy(np.array(getattr(p, f)))
                             for f in augment.AugParams._fields))
    xt, yt = augment.apply_params(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(y), tp, fields=torch.from_numpy(fields))
    xt = xt.numpy().transpose(0, 2, 3, 1)
    assert np.abs(xt - xj).max() <= 1e-4
    assert (yt.numpy() != yj).mean() <= 5e-3


def test_elastic_field_has_jax_scale():
    """JAX's field and the port's: the same law (blurred uniform noise
    scaled to a standard deviation of alpha / 3); each seed its own."""
    h, w = 64, 48
    want = np.stack([np.asarray(f) for f in jaug._elastic_field(
        jnp.uint32(5), h, w)])
    lag1 = []
    for d in (augment.elastic_field(5, h, w).numpy(), want):
        assert d.shape == (2, h, w)
        np.testing.assert_allclose(d.reshape(2, -1).std(axis=1), 20 / 3,
                                   rtol=1e-4)
        z = (d - d.mean(axis=(1, 2), keepdims=True)).reshape(2, h, w)
        lag1.append(float((z[:, :, 1:] * z[:, :, :-1]).mean()
                          / (z * z).mean()))
    # sigma-6 smoothing: neighbours nearly equal, in both fields alike
    assert min(lag1) > 0.97 and abs(lag1[0] - lag1[1]) < 0.02, lag1
    a, b = augment.elastic_field(5, h, w), augment.elastic_field(6, h, w)
    assert torch.equal(a, augment.elastic_field(5, h, w))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("recipe", ["light", "heavy"])
def test_rank_rows_augment_as_the_global_batch(recipe):
    """``augment_batch(rows=)``: a rank's rows come out as those rows of the
    whole batch augmented at once, and the generator ends where it would."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 2, 24, 20)).astype(np.float32))
    y = (x[:, 0] > 0.3).to(torch.uint8)
    gen = torch.Generator().manual_seed(9)
    xw, yw = augment.augment_batch(x, y, gen, recipe)
    after = gen.get_state()
    for rows in (slice(0, 3), slice(3, 6)):
        g = torch.Generator().manual_seed(9)
        xr, yr = augment.augment_batch(x[rows], y[rows], g, recipe,
                                       rows=rows, batch=6)
        assert torch.equal(xr, xw[rows]) and torch.equal(yr, yw[rows])
        assert torch.equal(g.get_state(), after)
