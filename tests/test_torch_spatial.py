"""The depth-halo 3-D convolutions and the depth-sharded 3-D U-Net on a
``(data, depth)`` grid of ranks against the JAX package's
``parallel/spatial.py`` on a 2-device mesh and against one rank: one spawn
of 4 one-thread CPU ranks as a ``(2, 2)`` grid (gloo) runs the conv stack,
its gradients and two faulty halo exchanges, the whole U-Net at three
depths, a float64 step with its two mutations, a trainer epoch and
``train.trainer3d``'s and ``cli.infer --ckpt3d --spatial-parallel 2``'s
CLI ranks; every test of the file reads that spawn
(``tests/_torch_p2p_ranks.py`` holds the ranks' work).

Tolerances, each stated where it is checked:
- the conv stack and the one conv (f32) against JAX's
  ``conv3d_stack_depth_sharded`` / ``conv3d_depth_sharded`` on
  ``make_mesh(2)`` and against the unsharded conv: rtol / atol 1e-5 (JAX's
  ``test_conv3d_depth_sharded_matches_unsharded``; its stack test allows
  1e-4); its float64 gradients within 1e-12 of each tensor's max; a halo
  sent the wrong way, or not zeroed at the volume's ends, misses by more
  than 1e-2 of the output's max (the mutations);
- the U-Net (channels (4, 8, 12), 16x16 planes, f32, JAX's weights)
  against JAX's ``unet3d_depth_sharded_apply`` on ``make_depth_mesh(2)``:
  rtol / atol 1e-4, JAX's own, at depths 16 (two units a rank), 12 (two
  and one: unequal bands) and 4 (one unit: replicated, no exchange);
- the float64 step on the grid (DiceCE, batch 2, a row a data rank, a band
  a depth rank) against one rank: the loss and every gradient within
  1e-10 of its tensor's max, except the conv biases that an InstanceNorm
  follows, whose gradient is zero up to rounding (held within 1e-10 of
  the largest gradient); the gradients averaged over the data sub-group
  alone, and the forward with each band's own norm statistics, miss by
  far more (the mutations);
- the trainer epoch on the ``(2, 2)`` grid: the train and validation
  losses within 1e-4 of one rank (JAX's ``_dryrun_unet3d_spatial``), the
  ranks' parameters equal, and within 2 * lr of one rank's;
- ``cli.infer``: probabilities within 1e-5 of the one-rank CLI's, masks
  equal away from 1e-5 of the threshold, the same Dice.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_p2p_ranks as ranks
from mri_acl_imagesegmentation_adsp_tpu.models import unet3d as junet3d
from mri_acl_imagesegmentation_adsp_tpu.parallel.mesh import make_mesh
from mri_acl_imagesegmentation_adsp_tpu.parallel import spatial as jsp
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh

F64_RTOL = 1e-10
LR = 1e-3


def _ndhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _dhwio(k):
    return jnp.asarray(np.transpose(k, (2, 3, 4, 1, 0)))


def _jax_unet():
    """JAX's (4, 8, 12) U-Net from a seeded numpy initializer (scale 0.3),
    its forward depth-sharded over ``make_depth_mesh(2)`` at depths 16, 12
    and 4; returns its weights as the port's state_dict and the outputs
    (NCDHW)."""
    jm = junet3d.ResidualUNet3D(classes=1, channels=ranks.CHANNELS,
                                fused_up=False)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)),
        train=True))["params"]
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(
        np.float32), shapes)
    run = jsp.unet3d_depth_sharded_apply(jm, {"params": p},
                                         jsp.make_depth_mesh(2))
    outs = {d: np.moveaxis(np.asarray(run(_ndhwc(ranks.volume(d, d)))),
                           -1, 1) for d in (16, 12, 4)}
    state = {k: v.numpy() for k, v in state_dict_from_flax_unet3d(p).items()}
    return state, outs


def _packs(root):
    """Two 16-slice 24x24 volumes, a compact positive region each."""
    rng = np.random.default_rng(0)
    files = []
    for v in range(2):
        img = rng.standard_normal((16, 1, 24, 24)).astype(np.float32)
        msk = np.zeros((16, 24, 24), np.uint8)
        msk[5:9, 8:16, 8:16] = 1
        d = root / f"v{v}"
        d.mkdir(parents=True)
        np.savez_compressed(d / "volume.npz", img=img, msk=msk)
        files.append(str(d / "volume.npz"))
    (root / "list.txt").write_text("\n".join(files))
    return str(root / "list.txt")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """JAX's sharded forwards, then the one spawn of the ``(2, 2)``
    grid; the ranks' results by rank."""
    root = tmp_path_factory.mktemp("depth_grid")
    state, jax_outs = _jax_unet()
    lists = _packs(root / "packs")
    got = mesh.spawn(ranks.spatial_rank, 4, ["cpu"] * 4, threads=1,
                     args=(state, lists, str(root)), timeout_s=600)
    return {"state": state, "jax": jax_outs, "ranks": got, "lists": lists,
            "root": root}


def _bands(grid, key):
    """Data block 0's depth bands of ``key`` in depth order (block 1's
    equal to them)."""
    r = grid["ranks"]
    for a, b in ((r[0], r[2]), (r[1], r[3])):
        np.testing.assert_array_equal(a[key], b[key])
    return np.concatenate([r[0][key], r[1][key]], axis=2)


def _within(got, want, rtol, name=""):
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (name, err)
    return err


def test_grid_places_ranks_data_major(grid):
    assert [r["place"] for r in grid["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_conv_stack_matches_jax_and_unsharded(grid):
    x, ks, w = ranks.stack_inputs()
    got = _bands(grid, "stack")
    want = np.moveaxis(np.asarray(jsp.conv3d_stack_depth_sharded(
        _ndhwc(x), [_dhwio(k) for k in ks], make_mesh(2))), -1, 1)
    assert got.shape == want.shape == (1, 4, 24, 5, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain, _ = ranks.stack_reference(x, ks, w)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    xo, ko = ranks.one_conv_inputs()
    want = np.moveaxis(np.asarray(jsp.conv3d_depth_sharded(
        _ndhwc(xo), _dhwio(ko), make_mesh(2))), -1, 1)
    np.testing.assert_allclose(_bands(grid, "one"), want, rtol=1e-5,
                               atol=1e-5)


def test_conv_stack_validates_as_jax(grid):
    """A depth the ranks do not divide, even kernel sides and a band
    thinner than a halo raise JAX's errors."""
    want = []
    for xs, kshape in ((13, (3, 3, 3)), (8, (2, 3, 3)), (8, (3, 2, 3)),
                       (2, (5, 3, 3))):
        with pytest.raises(ValueError) as exc:
            jsp.conv3d_depth_sharded(jnp.zeros((1, xs, 4, 4, 1)),
                                     jnp.zeros(kshape + (1, 1)),
                                     make_mesh(2))
        want.append(str(exc.value))
    for r in grid["ranks"]:
        assert r["errors"] == want


def test_conv_stack_gradients_float64_equal_one_rank(grid):
    _, grads = ranks.stack_reference(*ranks.stack_inputs(np.float64))
    for r in grid["ranks"]:
        for i, (g, w) in enumerate(zip(r["stack_grads"], grads)):
            _within(g, w, 1e-12, i)


@pytest.mark.parametrize("fault", ["wrap", "swap"])
def test_faulty_halo_exchange_fails(grid, fault):
    """The mutations: the halo of a ring (the ends not zeroed) and a halo
    of the wrong edge miss the unsharded stack by far more than the
    tolerance, which the right exchange meets."""
    x, ks, w = ranks.stack_inputs(np.float64)
    want, _ = ranks.stack_reference(x, ks, w)
    _within(_bands(grid, "stack"), want.numpy(), 1e-5)
    err = float(np.abs(_bands(grid, f"stack_{fault}") - want.numpy()).max())
    print(f"{fault}: {err:.3g} of max {float(want.abs().max()):.3g}")
    assert err > 1e-2 * float(want.abs().max()), err


@pytest.mark.parametrize("depth", [16, 12, 4])
def test_unet3d_matches_jax_depth_sharded(grid, depth):
    """Two units a rank, unequal bands (two and one), and one unit
    (replicated: no point-to-point sends)."""
    got = grid["ranks"][0][f"unet_{depth}"]
    for r in grid["ranks"]:
        np.testing.assert_array_equal(r[f"unet_{depth}"], got)
    assert got.shape == (1, 1, depth, 16, 16)
    np.testing.assert_allclose(got, grid["jax"][depth], rtol=1e-4,
                               atol=1e-4)
    sends = grid["ranks"][0][f"sends_{depth}"]["sends"]
    assert (sends == 0) == (depth == 4), sends


@functools.lru_cache(maxsize=None)
def _one_rank_f64():
    x, y = (torch.from_numpy(a) for a in ranks.grid_case())
    m = ranks.unet3d(torch.float64, seed=3).train()
    loss, grads = ranks.step_grads(m, x, y)
    names = [n for n, _ in m.named_parameters()]
    return float(loss.detach()), names, [g.numpy() for g in grads]


def _zero_grad(name):
    """A conv bias an InstanceNorm follows: its gradient is zero."""
    return ".convs." in name and name.endswith(".bias")


def test_grid_step_float64_equals_one_rank(grid):
    loss, names, grads = _one_rank_f64()
    top = max(float(np.abs(g).max()) for g in grads)
    for r in grid["ranks"]:
        got = r["f64"]
        assert abs(float(got["loss"]) - loss) <= F64_RTOL * abs(loss)
        for n, g, w in zip(names, got["grads"], grads):
            if _zero_grad(n):
                assert np.abs(g - w).max() <= F64_RTOL * top, n
            else:
                _within(g, w, F64_RTOL, n)


def test_data_only_gradient_average_fails(grid):
    """The mutation: the gradients averaged over the data sub-group only
    (each depth rank keeping the gradient of the sum of its depth ranks'
    losses with respect to its own copy) miss one rank by far more than
    the tolerance, and differ between the depth ranks."""
    _, names, grads = _one_rank_f64()
    worst = max(float(np.abs(g - w).max() / np.abs(w).max())
                for r in grid["ranks"]
                for n, g, w in zip(names, r["f64"]["data_only_grads"], grads)
                if not _zero_grad(n))
    print(f"data-only average: worst gradient {worst:.3g} of its max")
    assert worst > 1e8 * F64_RTOL, worst
    a, b = grid["ranks"][0]["f64"], grid["ranks"][1]["f64"]
    assert not all(np.array_equal(x, y) for x, y in zip(
        a["data_only_grads"], b["data_only_grads"]))


def test_band_local_norm_statistics_fail(grid):
    """The mutation: each band normalized by its own statistics misses the
    one-rank forward by far more than the tolerance."""
    with torch.no_grad():
        want = ranks.unet3d(torch.float64, seed=3).eval()(torch.from_numpy(
            ranks.volume(16, 16, 1, np.float64))).numpy()
    got = grid["ranks"][0]["local_norm"]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"band-local norm statistics: {err:.3g} of the logits' max")
    assert err > 1e-2, err


def test_trainer_epoch_on_the_grid_matches_one_rank(grid, tmp_path):
    want = ranks.trainer3d_run(grid["lists"], str(tmp_path / "one"))
    r0 = grid["ranks"][0]["trainer"]
    for r in grid["ranks"]:
        got = r["trainer"]
        assert abs(got["train_loss"] - want["train_loss"]) < 1e-4
        assert abs(got["val_loss"] - want["val_loss"]) < 1e-4
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v, r0["params"][k])
    for k, v in want["params"].items():
        diff = np.abs(r0["params"][k] - v.numpy())
        assert diff.max() <= 2 * LR, k


def test_trainer3d_cli_rank_on_the_grid(grid):
    """``--data-parallel 2 --spatial-parallel 2``: every rank the same
    best loss, rank 0 the run's files."""
    outs = [r["cli"] for r in grid["ranks"]]
    assert len({o["best_val_loss"] for o in outs}) == 1
    run = grid["root"] / "cli"
    log = (run / "train_log.csv").read_text().splitlines()
    assert log[0] == "epoch,train_loss,val_loss,lr" and len(log) == 2
    assert (run / "best3d.ckpt").is_file()


def test_infer_ckpt3d_spatial_parallel_matches_one_rank(grid, tmp_path):
    """``cli.infer --ckpt3d --spatial-parallel 2``'s flags on 2 CPU ranks
    (each data block's depth ranks) against the one-rank CLI, on the
    trainer CLI's checkpoint."""
    said = [r["infer_said"] for r in grid["ranks"]]
    assert said[1] == said[3] == ""          # depth rank 0 writes
    assert said[0] == said[2] and said[0].count("over 2 shards") == 2
    assert infer.main(ranks.infer_flags(grid["lists"], str(grid["root"]))
                      + ["--out-dir", str(tmp_path), "--device", "cpu"]) == 0
    one = json.loads((tmp_path / "summary.json").read_text())
    for block in (0, 1):
        two_dir = grid["root"] / f"infer{block}"
        two = json.loads((two_dir / "summary.json").read_text())
        assert len(one) == len(two) == 2
        for a, b in zip(one, two):
            assert a["num_slices"] == b["num_slices"] == 16
            name = a["volume"].split("/")[-2]
            with np.load(tmp_path / name / "probs.npz") as z:
                p1 = z["probs"]
            with np.load(two_dir / name / "probs.npz") as z:
                p2 = z["probs"]
            np.testing.assert_allclose(p2, p1, atol=1e-5)
            m1 = np.load(tmp_path / name / "pred_mask.npy")
            m2 = np.load(two_dir / name / "pred_mask.npy")
            near = np.abs(p1 - 0.5) < 1e-5
            np.testing.assert_array_equal(m2[~near], m1[~near])
            assert abs(a["dice"] - b["dice"]) <= 1e-6
