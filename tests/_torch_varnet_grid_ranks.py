"""Rank functions of ``tests/test_torch_varnet_shard.py``: the coil-parallel
VarNet, its trainer and ``cli.train_varnet`` on a ``(2, 2)`` grid of CPU
ranks.

``parallel.spawn`` starts each rank in a new process that imports the
function by name, so it lives here, in a module that imports torch and the
port only (no JAX). The inputs are made from seeds by the functions below,
which the tests call too for the one-device runs.
"""

from __future__ import annotations

import numpy as np
import torch

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import train_varnet
from mri_acl_imagesegmentation_adsp_tpu_torch.data.transforms import (
    VarNetSample)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
    init_fastmri_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.recon.varnet import VarNet
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    varnet_trainer as tvt)

GRID = (2, 2)                           # (data, coil)
B, COILS, H, W = 2, 4, 16, 16
TINY = dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2)
LR = 1e-3
NARROW = dict(num_cascades=2, chans=4, pools=2, sens_chans=4, sens_pools=2,
              lr=LR, crop=12, amp=False, bvalue="custom", epochs=1,
              batch_size=2, seed=7)


def inputs(seed: int, coils: int = COILS, dtype=np.float32):
    """Seeded k-space and ESPIRiT maps ``(B, coils, 1, H, W, 2)``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, coils, 1, H, W, 2)).astype(dtype)
                 for _ in range(2))


def model(dtype: torch.dtype, state=None, grid=None) -> VarNet:
    """The tiny VarNet (one cascade), its weights ``state`` (numpy, by
    name) or drawn from seed 0."""
    m = VarNet(aves=1, sens_aves=1, dtype=dtype, mesh=grid, **TINY)
    if state is None:
        init_fastmri_weights(m, torch.Generator().manual_seed(0))
    else:
        m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return m.double() if dtype == torch.float64 else m


def loss_and_grads(m: VarNet, k: np.ndarray, e: np.ndarray):
    """``mean(|image|^2)`` over the rows the model returns, the output and
    the gradients in parameter order."""
    out = m(torch.from_numpy(k), torch.from_numpy(e))
    loss = torch.mean(out * out)
    return loss, out.detach(), list(torch.autograd.grad(loss,
                                                        m.parameters()))


def samples(n: int, seed: int, vol: str = "vol"):
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


def trainer_run(out_dir: str, grid=None) -> dict:
    """One epoch (one AdamW step on a batch of 2) and a validation of the
    narrow trainer, and its parameters after them."""
    tr = tvt.VarNetTrainer(tvt.VarNetArgs(out_dir=out_dir, **NARROW),
                           samples(2, 0), samples(1, 1, "val"), mesh=grid,
                           device="cpu")
    loss = tr.train_one_epoch()
    val = tr.validate()
    return {"train_loss": loss, "val": val,
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()}}


def grid_rank(group: mesh.DataGroup, jax_state: dict, out_dir: str,
              cli_argv: list) -> dict:
    """Everything the test file holds, on one rank of the ``(2, 2)``
    grid."""
    grid = mesh.make_recon_grid(group, *GRID)
    out = {"place": (grid.data.rank if grid.data else 0,
                     grid.coil.rank if grid.coil else 0)}
    with torch.no_grad():
        out["f32_jax_weights"] = model(torch.float32, jax_state, grid)(
            *map(torch.from_numpy, inputs(0)))
    loss, rows, grads = loss_and_grads(model(torch.float64, grid=grid),
                                       *inputs(1, dtype=np.float64))
    avg = mesh.grid_average(grads + [loss.detach()], grid)
    data_only = mesh.average_flat(grads + [loss.detach()], grid.data)
    out["f64"] = {"out": rows, "loss": avg[-1], "grads": avg[:-1],
                  "data_only_grads": data_only[:-1]}
    with torch.no_grad():
        out["coils3"] = model(torch.float64, grid=grid)(
            *map(torch.from_numpy, inputs(2, coils=3, dtype=np.float64)))
    out["trainer"] = trainer_run(f"{out_dir}/trainer_{group.rank}", grid)
    out["cli"] = train_varnet.run_rank(
        group, train_varnet.build_parser().parse_args(cli_argv))
    return out
