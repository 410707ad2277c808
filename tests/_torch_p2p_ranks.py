"""Rank functions of ``tests/test_torch_spatial.py`` and
``tests/test_torch_pipeline.py``: the depth-halo 3-D convolutions, the
depth-sharded 3-D U-Net, its trainer and ``cli.infer --ckpt3d`` on a
``(data, depth)`` grid of CPU ranks, and GPipe, the pipelined VarNet, its
trainer and ``cli.train_varnet --pipeline-parallel`` on a pipe of CPU
ranks.

``parallel.spawn`` starts each rank in a new process that imports the
function by name, so it lives here, in a module that imports torch and the
port only (no JAX). The inputs are made from seeds by the functions below,
which the tests call too for the one-rank runs.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer, train_varnet
from mri_acl_imagesegmentation_adsp_tpu_torch.data.transforms import (
    VarNetSample)
from mri_acl_imagesegmentation_adsp_tpu_torch.models import norm
from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
    init_fastmri_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet3d import (
    ResidualUNet3D, init_weights3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import (
    mesh, pipeline, spatial)
from mri_acl_imagesegmentation_adsp_tpu_torch.recon.varnet import VarNet
from mri_acl_imagesegmentation_adsp_tpu_torch.train import trainer3d as t3d
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    varnet_trainer as tvt)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.losses import (
    dice_ce_loss_3d_binary)

# ---------------------------------------------------------------------------
# Depth sharding
# ---------------------------------------------------------------------------

GRID = (2, 2)                       # (data, depth)
CHANNELS = (4, 8, 12)               # a 4-plane unit
STACK = ((6, 2, 3, 3, 3), (6, 6, 3, 1, 1), (4, 6, 3, 3, 3))


def stack_inputs(dtype=np.float32):
    """JAX's stack test's volume ``(1, 2, 24, 5, 6)`` and kernels (the
    port's layouts), and a weight for a loss of the output."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, 24, 5, 6)).astype(dtype)
    ks = [(0.2 * rng.standard_normal(s)).astype(dtype) for s in STACK]
    w = rng.standard_normal((1, 4, 24, 5, 6)).astype(dtype)
    return x, ks, w


def one_conv_inputs():
    """A ``(2, 4, 16, 6, 5)`` volume and a ``(7, 4, 3, 3, 3)`` kernel."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 4, 16, 6, 5)).astype(np.float32),
            rng.standard_normal((7, 4, 3, 3, 3)).astype(np.float32))


def stack_reference(x, ks, w):
    """The unsharded SAME stack (ReLU between) in float64, its output, and
    the gradients of ``sum(y * w)`` by the kernels and by ``x``."""
    xt = torch.from_numpy(x).requires_grad_()
    kt = [torch.from_numpy(k).requires_grad_() for k in ks]
    y = xt
    for i, k in enumerate(kt):
        p = [(s - 1) // 2 for s in k.shape[2:]]
        y = torch.nn.functional.conv3d(y, k, padding=p)
        if i + 1 < len(kt):
            y = torch.relu(y)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), kt + [xt])
    return y.detach(), [g.numpy() for g in grads]


def faulty_halos(fault: str):
    """``exchange_depth_halos`` with a fault put back: ``wrap`` (the ends
    get the far end's planes, a ring, instead of zeros) or ``swap`` (a rank
    sends the wrong edge, its first planes to the next rank and its last
    to the one before)."""
    def run(x, before, after, group):
        r, n, d = group.rank, group.world, x.shape[2]
        zb = x.new_zeros(x.shape[:2] + (before,) + x.shape[3:])
        za = x.new_zeros(x.shape[:2] + (after,) + x.shape[3:])

        def one(planes, to, like, frm):
            got = mesh.exchange([(planes, to)] if to is not None else [],
                                [(like, frm)] if frm is not None else [],
                                group)
            return got[0] if got else like
        nxt_r = r + 1 if r + 1 < n else None
        prev_r = r - 1 if r > 0 else None
        if fault == "wrap":
            prev = one(x[:, :, d - before:], (r + 1) % n, zb, (r - 1) % n)
            nxt = one(x[:, :, :after], (r - 1) % n, za, (r + 1) % n)
        else:
            prev = one(x[:, :, :before], nxt_r, zb, prev_r)
            nxt = one(x[:, :, d - after:], prev_r, za, nxt_r)
        return torch.cat([prev, x, nxt], dim=2)
    return run


def unet3d(dtype: torch.dtype, state=None, seed: int = 0, remat=True):
    """The narrow 3-D U-Net, its weights ``state`` (numpy, by name) or
    drawn from ``seed``."""
    m = ResidualUNet3D(channels=CHANNELS, dtype=dtype, remat=remat)
    if state is None:
        init_weights3d(m, torch.Generator().manual_seed(seed))
    else:
        m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return m.double() if dtype == torch.float64 else m


def volume(depth: int, seed: int, batch: int = 1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 1, depth, 16, 16)).astype(dtype)


def grid_case():
    """The float64 grid step's patches ``(2, 1, 16, 16, 16)`` and binary
    labels ``(2, 16, 16, 16)``."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, 16, 16, 16))
    y = (rng.random((2, 16, 16, 16)) > 0.6).astype(np.float64)
    return x, y


def step_grads(m, x: torch.Tensor, y: torch.Tensor, depth=None):
    """DiceCE and its gradients in parameter order, of ``m`` on (a band
    of) the patches; ``depth`` the band's group."""
    loss = dice_ce_loss_3d_binary(m(x), y[:, None], group=depth)
    return loss, list(torch.autograd.grad(loss, list(m.parameters())))


def _grid_step(grid: spatial.DepthGrid):
    """The float64 step on the grid: this rank's rows and band."""
    x, y = (torch.from_numpy(a) for a in grid_case())
    rows = mesh.row_slice(2, grid.data)
    x, y = x[rows], y[rows]
    m = unet3d(torch.float64, seed=3).train()
    xb, band, _ = spatial.band_for(x, grid.depth, 4)
    with spatial.depth_sharded(m, band):
        return step_grads(m, xb, y.narrow(1, band.start, band.size),
                          band.group)


def spatial_rank(group: mesh.DataGroup, jax_state: dict, lists: str,
                 out_dir: str) -> dict:
    """Everything ``tests/test_torch_spatial.py`` holds, on one rank of
    the ``(2, 2)`` grid."""
    grid = spatial.make_depth_mesh(group, GRID[1])
    depth = grid.depth
    out = {"place": (grid.data.rank, depth.rank)}
    x, ks, w = stack_inputs()
    with torch.no_grad():
        out["stack"] = spatial.conv3d_stack_depth_sharded(
            torch.from_numpy(x), [torch.from_numpy(k) for k in ks], depth)
        xo, ko = one_conv_inputs()
        out["one"] = spatial.conv3d_depth_sharded(
            torch.from_numpy(xo), torch.from_numpy(ko), depth)
    errors = []
    for xs, kshape in (((1, 1, 13, 4, 4), (1, 1, 3, 3, 3)),
                       ((1, 1, 8, 4, 4), (1, 1, 2, 3, 3)),
                       ((1, 1, 8, 4, 4), (1, 1, 3, 2, 3)),
                       ((1, 1, 2, 4, 4), (1, 1, 5, 3, 3))):
        try:
            spatial.conv3d_depth_sharded(torch.zeros(xs),
                                         torch.zeros(kshape), depth)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors

    # float64 gradients of sum(y * w): each rank's summed over the band
    x64, ks64, w64 = stack_inputs(np.float64)
    xt = torch.from_numpy(x64).requires_grad_()
    kt = [torch.from_numpy(k).requires_grad_() for k in ks64]
    y = spatial.conv3d_stack_depth_sharded(xt, kt, depth)
    wb = torch.from_numpy(w64).narrow(2, depth.rank * 12, 12)
    grads = torch.autograd.grad((y * wb).sum(), kt + [xt])
    out["stack_grads"] = [mesh.all_reduce_(g.clone(), depth) for g in grads]
    plain = spatial.exchange_depth_halos
    with torch.no_grad():
        for fault in ("wrap", "swap"):
            spatial.exchange_depth_halos = faulty_halos(fault)
            try:
                out[f"stack_{fault}"] = spatial.conv3d_stack_depth_sharded(
                    torch.from_numpy(x64), [torch.from_numpy(k)
                                            for k in ks64], depth)
            finally:
                spatial.exchange_depth_halos = plain

    # the whole U-Net with JAX's weights: 16 planes (2 + 2 units), 12
    # planes (2 + 1), 4 planes (one unit: replicated)
    m = unet3d(torch.float32, jax_state).eval()
    run = spatial.unet3d_depth_sharded_apply(m, depth)
    with torch.no_grad():
        for d in (16, 12, 4):
            mesh.reset_p2p_counts()
            out[f"unet_{d}"] = run(torch.from_numpy(volume(d, d)))
            out[f"sends_{d}"] = dict(mesh.P2P_COUNTS)

    # float64 step on the grid; the data-only average and the local-
    # statistics norm are the mutations
    loss, grads = _grid_step(grid)
    avg = mesh.average_flat(grads + [loss.detach()], group)
    data_only = mesh.average_flat(grads + [loss.detach()], grid.data)
    out["f64"] = {"loss": avg[-1], "grads": avg[:-1],
                  "data_only_grads": data_only[:-1]}
    plain_norm = norm._band_norm
    norm._band_norm = (lambda x, w, b, eps, g:
                       plain_norm(x, w, b, eps, None))
    try:
        with torch.no_grad():
            m64 = unet3d(torch.float64, seed=3).eval()
            out["local_norm"] = spatial.unet3d_depth_sharded_apply(
                m64, depth)(torch.from_numpy(volume(16, 16, 1, np.float64)))
    finally:
        norm._band_norm = plain_norm

    # the trainer, one epoch on the grid, and the CLIs
    out["trainer"] = trainer3d_run(lists, os.path.join(out_dir, "tr"),
                                   group)
    flags = trainer3d_flags(lists, os.path.join(out_dir, "cli"))
    out["cli"] = t3d._fit_rank(group, t3d.parse_args(
        flags + ["--data-parallel", "2", "--spatial-parallel", "2"]))
    # cli.infer --ckpt3d --spatial-parallel 2's rank on the run's best
    # checkpoint, each data block's two depth ranks one run
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        out["infer"] = infer.run_3d_rank(depth, infer.build_parser(
        ).parse_args(infer_flags(lists, out_dir) + [
            "--out-dir", os.path.join(out_dir, f"infer{grid.data.rank}"),
            "--spatial-parallel", "2", "--device", "cpu"]))
    out["infer_said"] = said.getvalue()
    return out


def infer_flags(lists: str, out_dir: str) -> list:
    """``cli.infer``'s flags on the trainer CLI's best checkpoint."""
    return ["--ckpt3d", os.path.join(out_dir, "cli", "best3d.ckpt"),
            "--list", lists, "--metrics", "--save-probs"]


def trainer3d_args(lists: str, out_dir: str, dp: int = 1, sp: int = 1):
    return t3d.UNet3DArgs(
        train_list=lists, val_list=lists, out_dir=out_dir, roi=(16, 16, 16),
        channels=CHANNELS, classes=1, batch_size=2, epochs=1, amp=False,
        samples_per_vol_train=2, samples_per_vol_val=1, seed=23,
        data_parallel=dp, spatial_parallel=sp)


def trainer3d_run(lists: str, out_dir: str, group=None) -> dict:
    """One epoch (two steps) and a validation of the narrow 3-D trainer,
    on one rank or on a ``(2, 2)`` grid."""
    dp, sp = GRID if group is not None else (1, 1)
    tr = t3d.UNet3DTrainer(trainer3d_args(lists, out_dir, dp, sp), "cpu",
                           group)
    return {"train_loss": tr.train_one_epoch(), "val_loss": tr.validate(),
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()}}


def trainer3d_flags(lists: str, out_dir: str) -> list:
    return ["--train-list", lists, "--val-list", lists, "--out-dir",
            out_dir, "--roi", "16", "16", "16", "--channels",
            *map(str, CHANNELS), "--epochs", "1", "--batch-size", "2",
            "--samples-per-vol-train", "2", "--samples-per-vol-val", "1",
            "--seed", "5"]


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

PIPE = 2
B, COILS, H, W = 2, 4, 16, 16
VARNET = dict(num_cascades=4, sens_chans=4, sens_pools=2, chans=4, pools=2)
NARROW = dict(num_cascades=2, chans=4, pools=2, sens_chans=4, sens_pools=2,
              lr=1e-3, crop=12, amp=False, bvalue="custom", epochs=1,
              batch_size=2, seed=7)


def affine_case():
    """JAX's ``test_gpipe_schedule_matches_sequential``: 4 stages of
    ``tanh(state * w + c)`` over 2 microbatches of 3 rows."""
    rng = np.random.default_rng(2024)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    c = rng.standard_normal((2, 3, 5)).astype(np.float32)
    return w, x, c


def affine_stage(p, state, consts):
    return (torch.tanh(state[0] * p + consts[0]),)


def affine_sequential(w, x, c):
    """The sequential program, its output and the gradient of
    ``sum(y ** 2)`` by the stage weights."""
    wt = torch.from_numpy(w).requires_grad_()
    y = torch.from_numpy(x)
    for s in range(len(w)):
        y = torch.tanh(y * wt[s] + torch.from_numpy(c))
    return y.detach(), torch.autograd.grad((y ** 2).sum(), wt)[0]


def varnet_inputs(dtype=np.float32):
    rng = np.random.default_rng(4)
    return tuple(rng.standard_normal((B, COILS, 1, H, W, 2)).astype(dtype)
                 for _ in range(2))


def varnet(dtype: torch.dtype, state=None, seed: int = 0) -> VarNet:
    """The 4-cascade VarNet, its weights ``state`` (numpy, by name) or
    drawn from ``seed``."""
    m = VarNet(aves=1, sens_aves=1, dtype=dtype, **VARNET)
    if state is None:
        init_fastmri_weights(m, torch.Generator().manual_seed(seed))
    else:
        m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return m.double() if dtype == torch.float64 else m


def mean_sq_grads(out: torch.Tensor, m):
    loss = torch.mean(out * out)
    return loss, pipeline.pipeline_grads(loss, list(m.parameters()))


def varnet_samples(n: int, seed: int, vol: str = "vol"):
    """VarNet samples of ``COILS`` coils: masked random k-space, RSS-1
    maps, a positive target of 14 rows (cropped to)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = rng.standard_normal((COILS, 1, 20, 16, 2)).astype(np.float32)
        k[..., 1::3, :] = 0.0
        e = rng.standard_normal((COILS, 1, 20, 16, 2)).astype(np.float32)
        e /= np.sqrt((e ** 2).sum(axis=(0, 4), keepdims=True))
        t = (0.5 + rng.random((14, 16))).astype(np.float32)
        out.append(VarNetSample(k, t, e, f"{vol}{i // 2}", i % 2,
                                float(t.max()), (20, 16)))
    return out


def varnet_trainer_run(out_dir: str, pipe=None) -> dict:
    """One epoch (one AdamW step on a batch of 2) and a validation of the
    narrow trainer, and its parameters after them."""
    tr = tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=out_dir, **NARROW),
                           varnet_samples(2, 0),
                           varnet_samples(1, 1, "val"), pipe_mesh=pipe,
                           device="cpu")
    loss = tr.train_one_epoch()
    val = tr.validate()
    return {"train_loss": loss, "val": val,
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()}}


def pipeline_rank(group: mesh.DataGroup, jax_state: dict, out_dir: str,
                  cli_argv: list) -> dict:
    """Everything ``tests/test_torch_pipeline.py`` holds, on one rank of
    the 2-rank pipe."""
    out = {}
    w, x, c = affine_case()
    stages = [torch.nn.Parameter(torch.from_numpy(w[s]))
              for s in range(len(w))]
    mesh.reset_p2p_counts()
    (y,) = pipeline.gpipe(group, affine_stage, stages,
                          (torch.from_numpy(x),), (torch.from_numpy(c),))
    loss = (y ** 2).sum()
    grads = pipeline.pipeline_grads(loss, stages)
    out["affine"] = {"y": y.detach(), "counts": dict(mesh.P2P_COUNTS),
                     "mean": mesh.average_flat(grads, group),
                     "sum": [mesh.all_reduce_(g.clone(), group)
                             for g in grads]}
    try:
        pipeline.gpipe(group, affine_stage, stages[:3],
                       (torch.from_numpy(x),), (torch.from_numpy(c),))
    except ValueError as exc:
        out["tile_error"] = str(exc)

    # the pipelined VarNet with JAX's weights, f32
    k, e = (torch.from_numpy(a) for a in varnet_inputs())
    m = varnet(torch.float32, jax_state)
    outp = pipeline.varnet_apply_pipelined(m, k, e, group, n_microbatches=2)
    loss, grads = mean_sq_grads(outp, m)
    *grads, loss = mesh.average_flat(grads + [loss.detach()], group)
    out["varnet"] = {"out": outp.detach(), "loss": loss, "grads": grads}

    # float64, random weights: the mean rule and its mutation (the sum)
    k, e = (torch.from_numpy(a) for a in varnet_inputs(np.float64))
    m = varnet(torch.float64, seed=1)
    loss, grads = mean_sq_grads(
        pipeline.varnet_apply_pipelined(m, k, e, group), m)
    out["f64"] = {"mean": mesh.average_flat(grads + [loss.detach()], group),
                  "sum": [mesh.all_reduce_(g.clone(), group)
                          for g in grads]}
    out["trainer"] = varnet_trainer_run(os.path.join(out_dir, "tr"), group)
    out["cli"] = train_varnet.run_rank(
        group, train_varnet.build_parser().parse_args(cli_argv))
    return out
