"""Rank functions of the data-parallel tests (``test_torch_parallel_*.py``).

``parallel.spawn`` starts each rank in a new process that imports the
function by name, so the functions live here, in a module that imports
torch and the port only (no JAX: the ranks start in about a second).
Each takes the rank's ``DataGroup`` first and returns numpy-convertible
results, which the tests hold against the same work on one process.
"""

from __future__ import annotations

import numpy as np
import torch

from mri_acl_imagesegmentation_adsp_tpu_torch.data import hbm_loader
from mri_acl_imagesegmentation_adsp_tpu_torch.data.hbm_loader import (
    gather_batch)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.norm import (
    BatchNorm2d, synced)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.train import engine as eng_mod
from mri_acl_imagesegmentation_adsp_tpu_torch.train import losses
from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
    make_optimizer)

LR, WD = 1e-3, 1e-4
NARROW = (32, 16, 16, 8, 8)
LOSS_KINDS = (("dice_bce", 1), ("tversky", 1), ("focal_tversky", 1),
              ("dice_ce", 3))


# ---------------------------------------------------------------------------
# Collectives, BatchNorm and the losses
# ---------------------------------------------------------------------------

def bn_inputs(n=8, c=3, hw=5):
    rng = np.random.default_rng(11)
    x = (2 * rng.standard_normal((n, c, hw, hw)) + 1).astype(np.float64)
    g = rng.standard_normal((n, c, hw, hw)).astype(np.float64)
    w = rng.uniform(0.5, 1.5, c).astype(np.float64)
    b = rng.standard_normal(c).astype(np.float64)
    return x, g, w, b


def bn_step(x, g, w, b, group=None, rows=None):
    """Train-mode forward of a float64 BatchNorm2d on ``x[rows]`` (the
    global batch's statistics under ``group``), the loss ``sum(y * g)``
    and its gradients."""
    bn = BatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    rows = rows or slice(None)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    with synced(bn, group):
        y = bn(xt)
        (y * torch.from_numpy(g[rows])).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def loss_inputs(classes, n=8, hw=6):
    rng = np.random.default_rng(12 + classes)
    logits = rng.standard_normal((n, classes, hw, hw))
    if classes == 1:
        t = (rng.random((n, 1, hw, hw)) > 0.6).astype(np.float64)
        t[0] = 0                     # a sample with an empty target
    else:
        t = rng.integers(0, classes, (n, hw, hw))
        t[t == 2] = 1                # class 2 absent from every target
    return logits, t


def loss_step(name, classes, group=None, rows=None):
    """The float64 loss of ``name`` on ``rows`` of the seeded batch and its
    gradient with respect to those logits."""
    logits, t = loss_inputs(classes)
    rows = rows or slice(None)
    lt = torch.from_numpy(logits[rows]).requires_grad_()
    fn = losses.LossManager(classes=classes, name=name)
    loss = fn(lt, torch.from_numpy(t[rows]), group=group)
    loss.backward()
    return {"loss": loss.detach(), "grad": lt.grad}


def collectives_rank(group):
    """Every check of the collectives, the synced BatchNorm and the
    losses on this rank, then again with the global sums of BatchNorm and
    of the losses replaced by each rank's own (the faults the mutation
    tests put back)."""
    rows = mesh.row_slice(8, group)
    out = {"rows": [rows.start, rows.stop]}
    x = torch.full((3,), float(group.rank + 1), dtype=torch.float64,
                   requires_grad=True)
    y = mesh.all_reduce_sum(x * (group.rank + 2), group)
    y.sum().backward()
    out["sum_fwd"], out["sum_grad"] = y.detach(), x.grad
    full = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    out["gathered"] = mesh.gather_rows(full[rows].clone(), 8, group)
    out["kept"] = mesh.gather_rows(full[:7].clone(), 7, group)  # no divide
    out["any"] = [mesh.any_rank(group.rank == 1, group),
                  mesh.any_rank(False, group)]
    out["bn"] = bn_step(*bn_inputs(), group=group, rows=rows)
    out["loss"] = {name: loss_step(name, c, group, rows)
                   for name, c in LOSS_KINDS}
    mesh._AllReduceSum.apply = lambda t, g: t     # each rank's own sums
    out["bn_local"] = bn_step(*bn_inputs(), group=group, rows=rows)
    out["loss_local"] = {name: loss_step(name, c, group, rows)
                         for name, c in LOSS_KINDS}
    return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def seg_batch(n, hw, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw)).astype(np.float32)
    yy, xx = np.mgrid[:hw, :hw]
    c = hw / 2
    y = np.stack([((yy - c + 2 - i % 5) ** 2 + (xx - c) ** 2
                   < (hw * hw / 16) * (1 + 0.2 * (i % 4)))
                  for i in range(n)]).astype(np.int32)
    return x, y


def seg_store(n, hw, k, dtype, device, group=None, shard=False):
    x, y = seg_batch(n, hw)
    half = n // 2
    src = hbm_loader.SliceStore(x, y, np.array([0, half]),
                                np.array([half, n - half]), [])
    return src.to_device(k, dtype, device, group=group, shard=shard)


def seg_model(cfg, dtype):
    torch.manual_seed(0)
    m = build_unet("unet", "resnet18", in_ch=cfg.get("k", 1),
                   decoder_channels=NARROW)
    if "state_dict" in cfg:
        m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in cfg["state_dict"].items()})
    else:
        from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
            init_weights)
        init_weights(m, torch.Generator().manual_seed(3))
    return m.to(dtype)


def _summed_flat_(tensors, group):
    """``average_flat`` without the division: the summed-gradient fault."""
    out = mesh.average_flat(tensors, group)
    return [t * group.world for t in out]


def engine_run(cfg, group=None):
    """The engine steps of ``cfg`` on one process or on ``group``: the
    first batch's ``grads_one``, then ``train_steps`` of ``perm``, then
    validation and (one class) the volume-sharded validation, each from
    the initial weights. Returns losses, gradients, parameters and BN
    statistics."""
    dtype = torch.float64 if cfg.get("f64") else torch.float32
    dev = torch.device("cpu")
    k, hw, n = cfg.get("k", 1), cfg.get("hw", 32), cfg.get("n", 12)
    store = seg_store(n, hw, k, dtype, dev, group, cfg.get("shard", False))
    perm = torch.as_tensor(np.asarray(cfg["perm"]), dtype=torch.long)

    def engine():
        m = seg_model(cfg, dtype)
        return Engine(m, losses.LossManager(cfg.get("classes", 1),
                                            cfg.get("loss", "dice_bce")),
                      make_optimizer(m.parameters(), LR, WD, 5.0),
                      classes=cfg.get("classes", 1), aug=cfg["aug"],
                      accum_steps=cfg.get("accum", 1), group=group)
    out = {}
    e = engine()
    x, y = gather_batch(store, perm[0])
    loss, grads = e.grads_one(x, y, torch.Generator().manual_seed(5))
    names = [nm for nm, _ in e.model.named_parameters()]
    out["grads_one"] = {"loss": loss.reshape(1),
                        **dict(zip(names, grads))}
    if cfg.get("grads_only"):
        return out
    e = engine()
    out["losses"] = e.train_steps(store, perm,
                                  torch.Generator().manual_seed(1))
    out["params"] = {nm: p.detach() for nm, p in e.model.named_parameters()}
    out["stats"] = {nm: b for nm, b in e.model.named_buffers()
                    if nm.endswith(("running_mean", "running_var"))}
    if not cfg.get("validate", True):
        return out
    e = engine()     # validation from the initial weights
    out["validate"] = torch.tensor(e.validate(store, cfg.get("val_bs", 4)),
                                   dtype=torch.float64)
    if cfg.get("classes", 1) == 1 and "vol_sizes" in cfg:
        world = group.world if group is not None else cfg["n_shards"]
        rows = []       # the rows this process runs the model on
        hook = e.model.register_forward_pre_hook(
            lambda m, a: rows.append(int(a[0].shape[0])))
        d, i, per_vol = e.validate_volume_sharded(
            store, cfg["vol_sizes"], world, cfg.get("val_bs", 4))
        hook.remove()
        out["volume_sharded"] = {"dice": d, "iou": i, "per_vol": per_vol,
                                 "rows_forwarded": sum(rows)}
        out["per_slice"] = e.per_slice_dice_iou(
            store, torch.arange(store.num_slices))
    return out


def engine_rank(group, cfgs):
    """Every config of ``cfgs`` on this rank; a config with ``"fault":
    "summed"`` runs with the ranks' gradients summed, not averaged."""
    results = []
    for cfg in cfgs:
        if cfg.get("fault") == "summed":
            eng_mod.average_flat = _summed_flat_
        results.append(engine_run(cfg, group))
        eng_mod.average_flat = mesh.average_flat
    return results


# ---------------------------------------------------------------------------
# The classifier and the 3-D trainer
# ---------------------------------------------------------------------------

def classifier_step(group=None):
    """One f32 train step (SGD: the parameters move by lr times the
    gradient) of the tiny ConvNeXt on a seeded batch of 4, and an eval
    step: the losses, the gathered logits and the parameters after the
    update."""
    import tempfile
    from mri_acl_imagesegmentation_adsp_tpu_torch.classify.trainer import (
        ClassifierArgs, ClassifierTrainer)

    class Split:
        weights = (1.0, 1.5)

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((4, 1, 32, 32)).astype(
        np.float32))
    y = torch.tensor([0.0, 1.0, 1.0, 0.0])
    with tempfile.TemporaryDirectory() as td:
        tr = ClassifierTrainer(
            ClassifierArgs(out_dir=td, model="tiny", amp=False,
                           optimizer="sgd", lr=1e-2,
                           data_parallel=group.world if group else 1),
            Split(), Split(), device="cpu", group=group)
        loss, logits = tr.train_step(x, y)
        vloss, vlogits = tr.eval_step(x, y, (1.0, 1.5))
        params = {nm: p.detach() for nm, p in tr.model.named_parameters()}
    return {"loss": loss.reshape(1), "logits": logits,
            "val_loss": vloss.reshape(1), "val_logits": vlogits,
            "params": params}


def trainer3d_step(list_txt, out_dir, group=None):
    """``UNet3DTrainer.grads_one`` of a narrow f32 model on the first host
    batch of 2 patches: its loss and gradients."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.train import trainer3d
    args = trainer3d.UNet3DArgs(
        train_list=list_txt, val_list=list_txt, out_dir=out_dir,
        roi=(16, 16, 8), channels=(4, 8), batch_size=2, epochs=1,
        amp=False, samples_per_vol_train=2, samples_per_vol_val=1,
        data_parallel=group.world if group else 1)
    tr = trainer3d.UNet3DTrainer(args, "cpu", group)
    x, y = next(tr._train_batches())
    loss, grads = tr.grads_one(*tr._to_device(x, y))
    names = [nm for nm, _ in tr.model.named_parameters()]
    return {"loss": loss.reshape(1), **dict(zip(names, grads))}


def trainers_rank(group, list_txt, out_dir):
    return {"classifier": classifier_step(group),
            "trainer3d": trainer3d_step(list_txt, f"{out_dir}/r{group.rank}",
                                        group)}
