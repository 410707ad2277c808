"""GPipe over ranks and VarNet's cascades as its stages against the JAX
package's ``parallel/pipeline.py`` programs and against one rank: one
spawn of 2 one-thread CPU ranks as a pipe (gloo) runs the schedule on an
affine stage, the pipelined VarNet in f32 (JAX's weights) and float64, a
``VarNetTrainer(pipe_mesh=)`` epoch and ``cli.train_varnet
--pipeline-parallel 2``'s rank; every test of the file reads that spawn
(``tests/_torch_p2p_ranks.py`` holds the ranks' work).

Tolerances, each stated where it is checked (JAX's test values):
- ``gpipe``, 4 stages over 2 ranks and 2 microbatches, against the
  sequential program: rtol / atol 1e-6 forward, rtol 1e-5 / atol 1e-6 on
  the gradients (``test_gpipe_schedule_matches_sequential``); the
  gradients summed over the ranks instead of averaged miss by a factor of
  2 (the mutation);
- ``varnet_apply_pipelined`` (4 cascades, ``chans`` 4, 16x16, 2
  microbatches) against JAX's unrolled VarNet with the same weights: rtol
  / atol 2e-5 forward, the loss ``mean(|image|^2)`` within 1e-6 of itself
  (JAX's 1e-6 is absolute on a loss near 1; this one is near 139, where
  one f32 ulp is 1.5e-5) and each
  gradient's distance by norm within 1e-3 of its own
  (``test_varnet_pipeline_forward_and_grads_match``,
  ``_dryrun_varnet_pp``);
- the same in float64 against one rank: the loss and every gradient within
  1e-10 of its tensor's max; summed instead of averaged, the gradients
  miss (the mutation);
- the trainer epoch on the pipe: the train and validation losses within
  1e-5 of one rank (``test_varnet_trainer_pipeline_parallel_matches``),
  both ranks' parameters equal, and within 2 * lr of one rank's, at most
  1 % of elements past 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_p2p_ranks as ranks
from mri_acl_imagesegmentation_adsp_tpu.models import fastmri_unet as jfm
from mri_acl_imagesegmentation_adsp_tpu.recon import varnet as jvn
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import train_varnet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_varnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.native import load_h5_slab
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh, pipeline
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.varnet_synthetic import (
    write_dwi_h5)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    varnet_trainer as tvt)

F64_RTOL = 1e-10


def _jax_varnet():
    """JAX's unrolled 4-cascade VarNet (its plain lowering), kernels from a
    seeded numpy He-normal stream, norm parameters and ``dc_weight`` drawn
    at random; the loss ``mean(|image|^2)`` and its gradients, compiled at
    XLA's lowest backend optimization level. Returns the weights, the
    output, the loss and the gradients, the last two in the port's
    layout."""
    rng = np.random.default_rng(5)
    k, e = (jnp.asarray(a) for a in ranks.varnet_inputs())

    def init(key, shape, dtype=jnp.float32):
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((rng.standard_normal(shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32))
    old, jfm._conv_init = jfm._conv_init, init
    try:
        m = jvn.VarNet(phase_max_chans=0, **ranks.VARNET)
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

    def loss_out(p):
        out = m.apply({"params": p}, k, e)
        return jnp.mean(out ** 2), out
    opts = {"xla_backend_optimization_level": 0}
    fn = jax.jit(jax.value_and_grad(loss_out, has_aux=True))
    (loss, out), grads = fn.lower(params).compile(
        compiler_options=opts)(params)

    def port(tree):
        return {n: t.numpy() for n, t in state_dict_from_flax_varnet(
            jax.tree_util.tree_map(np.asarray, tree)).items()}
    return port(params), np.asarray(out), float(loss), port(grads)


@pytest.fixture(scope="module")
def dwi_root(tmp_path_factory):
    """DWI cases of 2 coils: two of 2 slices to train, one of 2 slices to
    validate."""
    root = tmp_path_factory.mktemp("dwi_pipe")
    for split, cases in (("train", ((4, 2), (5, 2))), ("val", ((6, 2),))):
        (root / split).mkdir()
        for i, (seed, slices) in enumerate(cases):
            write_dwi_h5(str(root / split / f"case{i}.h5"), seed,
                         slices=slices)
    # the native slab reader, built once here rather than by every rank
    load_h5_slab(str(root / "val" / "case0.h5"), "kspace", [0])
    return root


def _cli_flags(root, out):
    return ["--data-path", str(root), "--out-dir", str(out), "--bvalue",
            "b50", "--num-cascades", "2", "--pools", "2", "--chans", "4",
            "--sens-pools", "2", "--sens-chans", "4", "--epochs", "1",
            "--no-amp", "--batch-size", "2", "--save-resume-every", "0",
            "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def pipe(tmp_path_factory, dwi_root):
    """JAX's unrolled VarNet, then the one spawn of the 2-rank pipe; the
    ranks' results by rank."""
    root = tmp_path_factory.mktemp("pipe")
    state, out, loss, grads = _jax_varnet()
    flags = _cli_flags(dwi_root, root / "cli") + ["--pipeline-parallel", "2"]
    got = mesh.spawn(ranks.pipeline_rank, 2, ["cpu"] * 2, threads=1,
                     args=(state, str(root), flags), timeout_s=600)
    return {"state": state, "jax": (out, loss, grads), "ranks": got,
            "cli_out": root / "cli"}


def _within(got, want, rtol, name=""):
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (name, err)
    return err


def test_gpipe_matches_the_sequential_program(pipe):
    w, x, c = ranks.affine_case()
    want, g_want = ranks.affine_sequential(w, x, c)
    for r in pipe["ranks"]:
        got = r["affine"]
        np.testing.assert_allclose(got["y"], want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(np.stack(got["mean"]), g_want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert r["tile_error"] == "3 stages do not tile a 2-way pipe axis"
    # a step's sends, one a microbatch each way: the forward's activations
    # from rank 0, the backward's gradients from rank 1
    assert [r["affine"]["counts"]["sends"] for r in pipe["ranks"]] == [2, 2]


def test_gpipe_gradient_sum_fails(pipe):
    """The mutation: summed over the pipe's ranks, the gradients are twice
    the sequential program's."""
    w, x, c = ranks.affine_case()
    _, g_want = ranks.affine_sequential(w, x, c)
    got = np.stack(pipe["ranks"][0]["affine"]["sum"])
    np.testing.assert_allclose(got, 2 * g_want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_varnet_pipelined_matches_jax_unrolled(pipe):
    out, loss, grads = pipe["jax"]
    names = [n for n, _ in ranks.varnet(torch.float32).named_parameters()]
    assert set(names) == set(grads)
    drift = 0.0
    for r in pipe["ranks"]:
        got = r["varnet"]
        assert got["out"].shape == out.shape == (ranks.B, 1, ranks.H,
                                                 ranks.W)
        np.testing.assert_allclose(got["out"], out, rtol=2e-5, atol=2e-5)
        assert abs(float(got["loss"]) - loss) <= 1e-6 * abs(loss)
        for n, g in zip(names, got["grads"]):
            want = grads[n]
            d = float(np.linalg.norm(g - want)
                      / (np.linalg.norm(want) + 1e-8))
            drift = max(drift, d)
    print(f"pipelined VarNet against JAX: worst gradient drift {drift:.2e}")
    assert drift < 1e-3


@functools.lru_cache(maxsize=None)
def _one_rank_f64():
    k, e = (torch.from_numpy(a) for a in ranks.varnet_inputs(np.float64))
    m = ranks.varnet(torch.float64, seed=1)
    loss, grads = ranks.mean_sq_grads(m(k, e), m)
    return [g.numpy() for g in grads] + [loss.detach().numpy()]


def test_varnet_pipelined_float64_equals_one_rank(pipe):
    want = _one_rank_f64()
    for r in pipe["ranks"]:
        for i, (g, w) in enumerate(zip(r["f64"]["mean"], want)):
            _within(g, w, F64_RTOL, i)


def test_varnet_pipe_gradient_sum_fails(pipe):
    """The mutation: the pipe's gradients summed, not averaged, miss one
    rank by far more than the tolerance."""
    want = _one_rank_f64()[:-1]
    worst = max(float(np.abs(g - w).max() / np.abs(w).max())
                for g, w in zip(pipe["ranks"][0]["f64"]["sum"], want)
                if np.abs(w).max() > 0)
    print(f"summed pipe gradients: worst {worst:.3g} of its max")
    assert worst > 1e8 * F64_RTOL, worst


def test_stack_cascade_params_stacks_the_cascades(pipe):
    sd = {k: torch.from_numpy(v) for k, v in pipe["state"].items()}
    stacked = pipeline.stack_cascade_params(sd, ranks.VARNET["num_cascades"])
    assert set(stacked) == {k[len("cascades.0."):] for k in sd
                            if k.startswith("cascades.0.")}
    for n, v in stacked.items():
        assert v.shape[0] == 4
        for i in range(4):
            assert torch.equal(v[i], sd[f"cascades.{i}.{n}"])


def test_trainer_epoch_on_the_pipe_matches_one_rank(pipe, tmp_path):
    want = ranks.varnet_trainer_run(str(tmp_path))
    first = pipe["ranks"][0]["trainer"]
    for r in pipe["ranks"]:
        got = r["trainer"]
        assert abs(got["train_loss"] - want["train_loss"]) < 1e-5
        assert abs(got["val"]["validation_loss"]
                   - want["val"]["validation_loss"]) < 1e-5
        for name, p in got["params"].items():
            np.testing.assert_array_equal(p, first["params"][name])
    diff = np.concatenate([np.abs(first["params"][k] - v.numpy()).ravel()
                           for k, v in want["params"].items()])
    assert diff.max() <= 2 * 1e-3 and (diff > 1e-5).mean() <= 0.01


def test_trainer_pipe_checks_as_jax(tmp_path):
    """Cascades that do not tile the pipe, and a mesh beside a pipe, raise
    JAX's errors; a pipe must be a DataGroup."""
    two = mesh.DataGroup(2, 0, torch.device("cpu"), None, "gloo")
    bad = tvt.VarNetArgs(out_dir=str(tmp_path), num_cascades=3)
    with pytest.raises(ValueError, match="3 cascades do not tile a 2-way"):
        tvt.VarNetTrainer(bad, pipe_mesh=two, device="cpu")
    grid = mesh.ReconGrid(two, None, None)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=str(tmp_path)), mesh=grid,
                          pipe_mesh=two, device="cpu")
    with pytest.raises(TypeError, match="DataGroup"):
        tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=str(tmp_path)),
                          pipe_mesh=object(), device="cpu")
    for flags in (["--pipeline-parallel", "2", "--data-parallel", "2"],
                  ["--pipeline-parallel", "5"]):
        with pytest.raises(ValueError, match="mutually exclusive|tile"):
            train_varnet.main(["--data-path", str(tmp_path), *flags])


def test_cli_train_varnet_pipeline_parallel_writes_the_run(pipe, tmp_path,
                                                           dwi_root):
    """``cli.train_varnet --pipeline-parallel 2 --device cpu``'s ranks
    wrote the best checkpoint, the one-device run's parameters within
    2 * lr."""
    out = pipe["cli_out"]
    assert all(r["cli"] == 0 for r in pipe["ranks"])
    assert train_varnet.main(_cli_flags(dwi_root, tmp_path)) == 0
    got = checkpoint.load_best(str(out / "varnet_best.ckpt"))
    want = checkpoint.load_best(str(tmp_path / "varnet_best.ckpt"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.abs(np.asarray(got[k]) - np.asarray(v)).max() <= 2e-3, k
