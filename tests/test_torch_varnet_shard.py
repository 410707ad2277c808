"""The coil-parallel VarNet on a ``(data, coil)`` grid of ranks against the
JAX package's ``make_recon_mesh(2, 2)`` run and the port's one device: one
spawn of 4 one-thread CPU ranks as a ``(2, 2)`` grid (gloo) runs the
forward, the gradients, the uneven-coil fallback, a trainer step with its
validation and ``cli.train_varnet --data-parallel 2 --coil-parallel 2``;
every test of the file reads that spawn (``tests/_torch_varnet_grid_ranks
.py`` holds the ranks' work).

Tolerances, each stated where it is checked:
- the f32 forward with JAX's weights (one cascade) against JAX's forward
  on its ``(2, 2)`` mesh: rtol / atol 2e-5, JAX's own
  ``test_coil_tp_forward_matches_unsharded``;
- float64 forward, loss and every gradient against one device: within
  1e-10 of each tensor's largest magnitude (only the coil sums' order
  differs); the gradients averaged over the data sub-group alone miss it
  by orders of magnitude (the mutation);
- 3 coils on the 2-way coil axis (replicated, no sums): float64, 1e-10;
- the trainer (f32): the train loss within 1e-5 and the validation loss
  within 1e-4 of the meshless trainer (JAX's
  ``test_varnet_trainer_on_recon_mesh``), every rank's parameters
  bit-equal after the AdamW step, and within ``2 * lr`` of the meshless
  trainer's, at most 1 % of elements past 1e-5 (as
  ``tests/test_torch_varnet_trainer.py`` holds two steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_varnet_grid_ranks as ranks
from mri_acl_imagesegmentation_adsp_tpu.data import recon_data as jrd
from mri_acl_imagesegmentation_adsp_tpu.models import fastmri_unet as jfm
from mri_acl_imagesegmentation_adsp_tpu.parallel import make_recon_mesh
from mri_acl_imagesegmentation_adsp_tpu.recon import varnet as jvn
from mri_acl_imagesegmentation_adsp_tpu_torch.data import recon_data
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_varnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.native import load_h5_slab
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.varnet_synthetic import (
    write_dwi_h5)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint

F64_RTOL = 1e-10


def _jax_forward(k, e):
    """JAX's tiny VarNet (one cascade, its plain lowering) on its ``(2,
    2)`` mesh, compiled at XLA's lowest backend optimization level; its
    kernels from a seeded numpy He-normal stream, its norm parameters and
    ``dc_weight`` drawn at random. Returns its weights as the port's
    state_dict and the forward."""
    rng = np.random.default_rng(5)

    def init(key, shape, dtype=jnp.float32):
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((rng.standard_normal(shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32))
    old, jfm._conv_init = jfm._conv_init, init
    try:
        grid = make_recon_mesh(*ranks.GRID)
        m = jvn.VarNet(phase_max_chans=0, mesh=grid, **ranks.TINY)
        params = jax.jit(m.init)(jax.random.PRNGKey(0), k, e)["params"]
    finally:
        jfm._conv_init = old

    def randomized(path, v):
        v = np.asarray(v)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
        if name in ("bias", "dc_weight"):
            return (0.5 + 0.2 * rng.standard_normal(v.shape)).astype(
                v.dtype)
        return v
    params = jax.tree_util.tree_map_with_path(randomized, params)
    put = lambda x: jax.device_put(x, NamedSharding(  # noqa: E731
        grid, P("data", "coil")))
    v = {"params": params}
    out = jax.jit(m.apply).lower(v, put(k), put(e)).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        v, put(k), put(e))
    state = {n: t.numpy() for n, t in state_dict_from_flax_varnet(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return state, np.asarray(out)


@pytest.fixture(scope="module")
def dwi_root(tmp_path_factory):
    """DWI cases of 2 coils: two of 2 slices to train, one of 2 and one of
    3 slices to validate."""
    root = tmp_path_factory.mktemp("dwi_grid")
    for split, cases in (("train", ((4, 2), (5, 2))),
                         ("val", ((6, 2), (7, 3)))):
        (root / split).mkdir()
        for i, (seed, slices) in enumerate(cases):
            write_dwi_h5(str(root / split / f"case{i}.h5"), seed,
                         slices=slices)
    # the native slab reader, built once here rather than by every rank
    load_h5_slab(str(root / "val" / "case0.h5"), "kspace", [0])
    return root


def _cli_flags(root, out):
    return ["--data-path", str(root), "--out-dir", str(out), "--bvalue",
            "b50", "--num-cascades", "1", "--pools", "2", "--chans", "4",
            "--sens-pools", "2", "--sens-chans", "4", "--epochs", "1",
            "--no-amp", "--batch-size", "2", "--save-resume-every", "0",
            "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory, dwi_root):
    """JAX's sharded forward, then the one spawn of the ``(2, 2)`` grid;
    the ranks' results by rank."""
    root = tmp_path_factory.mktemp("grid")
    state, jax_out = _jax_forward(*ranks.inputs(0))
    flags = _cli_flags(dwi_root, root / "cli") + [
        "--data-parallel", "2", "--coil-parallel", "2"]
    got = mesh.spawn(ranks.grid_rank, 4, ["cpu"] * 4, threads=1,
                     args=(state, str(root), flags), timeout_s=600)
    return {"state": state, "jax": jax_out, "ranks": got,
            "cli_out": root / "cli"}


def _rows(grid, key):
    """The ranks' row blocks of ``key`` stacked in row order (the coil
    ranks of a data block returning the same rows)."""
    by_d = {}
    for r in grid["ranks"]:
        d, _ = r["place"]
        part = r[key] if not isinstance(r[key], dict) else r[key]["out"]
        if d in by_d:
            np.testing.assert_array_equal(part, by_d[d])
        by_d[d] = part
    return np.concatenate([by_d[d] for d in sorted(by_d)])


def _within(got, want, rtol, name=""):
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (name, err)
    return err


def test_grid_places_ranks_data_major(grid):
    assert [r["place"] for r in grid["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_forward_matches_jax_recon_mesh(grid):
    got = _rows(grid, "f32_jax_weights")
    assert got.shape == grid["jax"].shape == (ranks.B, 1, ranks.H, ranks.W)
    np.testing.assert_allclose(got, grid["jax"], rtol=2e-5, atol=2e-5)


def _one_device_f64():
    loss, out, grads = ranks.loss_and_grads(ranks.model(torch.float64),
                                            *ranks.inputs(1,
                                                          dtype=np.float64))
    return float(loss.detach()), out.numpy(), [g.numpy() for g in grads]


def test_float64_forward_and_gradients_equal_one_device(grid):
    loss, out, grads = _one_device_f64()
    _within(_rows(grid, "f64"), out, F64_RTOL, "out")
    for r in grid["ranks"]:
        got = r["f64"]
        assert abs(float(got["loss"]) - loss) <= F64_RTOL * abs(loss)
        for i, (g, w) in enumerate(zip(got["grads"], grads)):
            _within(g, w, F64_RTOL, i)


def test_data_only_gradient_average_fails(grid):
    """The mutation: the gradients averaged over the data sub-group only
    (the coil ranks' then differ, each counting its coil sums' share
    ``n_coil`` times) miss one device by far more than the tolerance."""
    _, _, grads = _one_device_f64()
    worst = max(float(np.abs(np.asarray(g) - w).max() / np.abs(w).max())
                for r in grid["ranks"]
                for g, w in zip(r["f64"]["data_only_grads"], grads)
                if np.abs(w).max() > 0)
    print(f"data-only average: worst gradient {worst:.3g} of its max")
    assert worst > 1e8 * F64_RTOL, worst
    a, b = grid["ranks"][0]["f64"], grid["ranks"][1]["f64"]
    assert not all(np.array_equal(x, y) for x, y in zip(
        a["data_only_grads"], b["data_only_grads"]))


def test_uneven_coils_are_replicated(grid):
    """3 coils on the 2-way coil axis: no coil sums across ranks, each coil
    rank the one device's rows."""
    with torch.no_grad():
        want = ranks.model(torch.float64)(*map(torch.from_numpy, ranks.inputs(
            2, coils=3, dtype=np.float64))).numpy()
    _within(_rows(grid, "coils3"), want, F64_RTOL)


def test_trainer_step_and_validate_on_the_grid(grid, tmp_path):
    want = ranks.trainer_run(str(tmp_path))
    first = grid["ranks"][0]["trainer"]
    for r in grid["ranks"]:
        got = r["trainer"]
        assert abs(got["train_loss"] - want["train_loss"]) < 1e-5
        assert abs(got["val"]["validation_loss"]
                   - want["val"]["validation_loss"]) < 1e-4
        for name, p in got["params"].items():
            np.testing.assert_array_equal(p, first["params"][name])
    diff = np.concatenate([np.abs(first["params"][k] - v.numpy()).ravel()
                           for k, v in want["params"].items()])
    assert diff.max() <= 2 * ranks.LR and (diff > 1e-5).mean() <= 0.01


def test_val_shards_match_jax(dwi_root):
    got = recon_data.FastMriDataModule(dwi_root, "b50",
                                       device="cpu").val_shards(2)
    want = jrd.FastMriDataModule(dwi_root, "b50").val_shards(2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the 3-slice volume (second in the listing) alone on the first shard
    np.testing.assert_array_equal(got[0], [2, 3, 4])
    assert sorted(set(np.concatenate(got))) == [0, 1, 2, 3, 4]


def test_cli_train_varnet_on_the_grid_writes_the_run(grid, tmp_path,
                                                      dwi_root):
    """``cli.train_varnet --data-parallel 2 --coil-parallel 2 --device
    cpu``'s ranks wrote the best checkpoint, with the one-device run's
    parameter names and shapes."""
    out = grid["cli_out"]
    assert all(r["cli"] == 0 for r in grid["ranks"])
    assert (out / "varnet_best.ckpt").exists()
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli import train_varnet
    assert train_varnet.main(_cli_flags(dwi_root, tmp_path)) == 0
    got = checkpoint.load_best(str(out / "varnet_best.ckpt"))
    want = checkpoint.load_best(str(tmp_path / "varnet_best.ckpt"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(np.isfinite(np.asarray(v)).all() for v in got.values())
