"""Training traffic: ``Engine.train_steps`` over a device slice store made
from the seed, one new permutation an epoch (the ragged tail dropped) and
one ``Engine.check_epoch_losses`` an epoch, as the trainer runs them.

Set-up builds the store (``SliceStore(...).to_device``), the model with
the benchmark's weights, the optimizer and the engine, and drives that
same engine through the whole first epoch: its first ``checked_steps``
steps are the ones the reference follows, the rest warm every shape. The
window then runs whole epochs until ``seconds`` have passed; the rate is
all its slices over all its time. After the window the program's state
is freed and the plain reference repeats the first steps from the same
weights, rows and augmentation seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..counts.flops import flops_per_slice
from ..harness import generator, sub_seed
from ..reference.compare import train_readings
from ..reference.models import bn_names
from ..reference.train_step import train_steps as reference_steps
from ..tracing import Trace
from ..traffic.synthetic import training_slices
from ..traffic.weights import make_weights


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, control: bool = False) -> dict:
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.hbm_loader import (
        SliceStore, epoch_permutation)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
    from mri_acl_imagesegmentation_adsp_tpu_torch.train.losses import (
        LossManager)
    from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
        make_optimizer)

    cfg, tr = cell["config"], cell["traffic"]
    h = w = int(cfg["image_size"])
    vols, per, batch = tr["volumes"], tr["slices_per_volume"], tr["batch"]
    n = vols * per
    first = int(tr["checked_steps"])
    rec = cfg["recipe"]

    # the store, as packs of ``per`` kept slices a volume
    imgs, masks = training_slices(generator(seed, 0, dev), n, h, w)
    host_imgs, host_masks = imgs.cpu().numpy(), masks.cpu().numpy()
    del imgs, masks
    store = SliceStore(
        images=host_imgs, masks=host_masks,
        vol_starts=np.arange(vols, dtype=np.int64) * per,
        vol_sizes=np.full(vols, per, np.int64), files=[]).to_device(
            1, getattr(torch, rec["store_dtype"]), dev)

    params, _ = make_weights(cfg["model"], generator(seed, 1, dev),
                             bn_shift=float(tr.get("bn_shift", 0.0)))
    with torch.device(dev):
        model = build_unet(cfg["model"], cfg["encoder"], in_ch=1, classes=1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    opt = make_optimizer(model.parameters(), rec["lr"], rec["weight_decay"],
                         rec["max_grad_norm"])
    eng = Engine(model, LossManager(classes=1, name=rec["loss"]), opt,
                 classes=1, aug=rec["aug"], amp=rec["amp"])
    names = [nm for nm, _ in model.named_parameters()]
    order = [names.index(nm) for nm in params]
    aug_gen = generator(seed, 2, dev)
    perm_gen = generator(seed, 3, dev)

    # the first epoch: the checked steps, then the rest as warm-up
    perm = epoch_permutation(perm_gen, n, batch)
    l1 = eng.train_steps(store, perm[:1], aug_gen)
    g1 = torch.stack(torch._foreach_norm(opt.mu)).double() / (1 - opt.b1)
    # the first step's batch variances, from the running ones it moved
    # (0.9 * 1 + 0.1 * var)
    bn_vars = torch.cat([
        (model.get_buffer(nm + ".running_var").double() - 0.9) / 0.1
        for nm, _ in bn_names(cfg["model"])]).cpu()
    l2 = eng.train_steps(store, perm[1:first], aug_gen)
    delta = torch.stack([(p.detach() - params[nm]).double().norm()
                         for nm, p in model.named_parameters()])
    prog = {"losses": torch.cat([l1, l2]).float().tolist(),
            "grad_norms": g1[order].cpu(), "delta_norms": delta[order].cpu(),
            "bn_vars": bn_vars}
    rest = eng.train_steps(store, perm[first:], aug_gen)
    Engine.check_epoch_losses(torch.cat([l1, l2, rest]), step=eng.step)
    rows = perm[:first].cpu().numpy()
    steps_per_epoch = int(perm.shape[0])
    _sync(dev)
    setup_s = time.time() - t_start

    epochs = 0
    with Trace(trace) as tr_:
        with tr_.window():
            t0 = time.perf_counter()
            while True:
                losses = eng.train_steps(
                    store, epoch_permutation(perm_gen, n, batch), aug_gen)
                with torch.profiler.record_function("bench::epoch_losses"):
                    Engine.check_epoch_losses(losses, step=eng.step)
                epochs += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    steps = epochs * steps_per_epoch
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    reduced = tr_.reduce()

    del eng, opt, model, store, perm, l1, l2, rest, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    images = torch.from_numpy(host_imgs[rows]).to(dev)
    targets = torch.from_numpy(host_masks[rows]).to(dev)
    ref = reference_steps(cfg["model"], params, images, targets,
                          sub_seed(seed, 2), rec)
    out = {
        "setup_s": setup_s,
        "e2e": {"train_slices_per_s": steps * batch / window_s},
        "readings": train_readings(prog, ref),
        "attempted": steps, "failed": 0,
        "memory_peak_bytes": peak, "trace": reduced,
        "ctx": {"window_s": window_s, "steps": steps, "batch": batch,
                "flops_per_slice": flops_per_slice(cfg["model"], h, w,
                                                   True)},
        "counts": {"steps": steps, "epochs": epochs, "slices": steps * batch,
                   "window_s": window_s, "reference_s": 0.0},
    }
    out["counts"]["losses"] = {"program": prog["losses"],
                               "reference": ref["losses"]}
    if control:
        ctl = reference_steps(cfg["model"], params, images, targets,
                              sub_seed(seed, 2), rec, quant=True)
        out["control_readings"] = train_readings(ctl, ref)
        out["counts"]["losses"]["control"] = ctl["losses"]
        half = reference_steps(cfg["model"], params, images, targets,
                               sub_seed(seed, 2), rec, drop_half=True)
        out["fault_readings"] = {"half_batch": train_readings(half, ref)}
        jit = reference_steps(cfg["model"], params, images, targets,
                              sub_seed(seed, 2), rec, jitter=True)
        out["jitter_readings"] = train_readings(jit, ref)
    out["counts"]["reference_s"] = time.perf_counter() - t_ref
    return out
