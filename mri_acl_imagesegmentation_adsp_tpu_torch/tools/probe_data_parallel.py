"""Data parallelism on one card: two ranks that share it over gloo against
one rank, at the reference configurations, with the checks that decide it.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_data_parallel \\
        --out chiprun_out/probe_dp.json

Run alone, the tool packs two synthetic volumes and spawns the two ranks;
``chip_smoke.py`` phase 15 runs :func:`rank_main` on packs it makes in
memory, in the same two ranks as ``graft_entry.dryrun_rank`` (a rank's
start on the card costs some 20 s of CUDA set-up). Needs a CUDA card.
Everything is f32 with TF32 off and cuDNN deterministic. The two ranks
share ``cuda:0`` (NCCL refuses two ranks on one device, so they meet over
gloo, every CUDA tensor copied through the host); rank 0 also computes
each one-rank reference, in its own process, and compares:

- ``step``: one ``Engine.grads_one`` of the ResNet34 U-Net at 320x320,
  dice_bce, light augmentation, global batch 8 (4 a rank), from seeded
  weights: the loss, every gradient and the BN running statistics, each
  held to ``FLOOR_X`` times how far the one-rank step moves when every
  input pixel moves by one f32 ulp (phase 6's rule), or to phase 6's fixed
  tolerance where that is larger;
- ``step_f64``: the same step in float64 on a ``F64_HW`` square centre
  crop of the batch, where rounding cannot hide a fault: the loss, every
  gradient and every BN running statistic within ``F64_RTOL`` of each
  tensor's max (phase 6's float64 rule; the full-width model, a smaller
  image, since float64 convolutions are slow);
- ``stores``: two ``train_steps`` from the same weights with the store
  replicated and row-sharded: bit-equal losses and parameters (the sharded
  gather is an exact exchange);
- ``timing``: ms a step on two ranks and on one (host clock around
  synchronized steps), ms of the gradient all-reduce (the f32 gradients
  and the loss, one flat buffer) and its bytes;
- ``volume_sharded``: ``validate_volume_sharded`` on the two ranks against
  one rank running both shards: per-volume Dice equal;
- ``trainer``: a one-epoch ``UNet2DTrainer`` run on the ranks (rank 0
  writing) against one on one rank: the same files, the same step count,
  the first step's loss within the step tolerance;
- ``classifier``: one ``ClassifierTrainer.train_step`` of ConvNeXt base at
  224x224, batch 32 (16 a rank), SGD at lr 1 so that the update is the
  gradient: the loss and the gathered logits within 1e-4, the update's
  median over tensors and global norm within 1e-3 (``fixed_rule``: no
  ulp floor is measured; the worst tensor is reported, not gated, since
  some tensors' gradients are rounding noise);
- ``unet3d``: ``UNet3DTrainer.grads_one`` at the reference width (channels
  32-64-128-256-320, ROI 160x160x64), batch 2 (1 a rank): the loss and
  the gradients under ``fixed_rule``.

A failed check raises. The result holds the numbers of each.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..classify.trainer import ClassifierArgs, ClassifierTrainer
from ..data.hbm_loader import (
    SliceStore, epoch_permutation, gather_batch, read_list)
from ..models.factory import build_unet
from ..models.unet2d import init_weights
from ..parallel.mesh import DataGroup, average_flat, barrier, spawn
from ..train.engine import Engine
from ..train.losses import LossManager
from ..train.optim import make_optimizer
from ..train.trainer import UNet2DArgs, UNet2DTrainer
from ..train.trainer3d import UNet3DArgs, UNet3DTrainer

RANKS = 2
GLOBAL_BATCH = 8
LOSS_RTOL, GRAD_RTOL, BN_RTOL = 1e-4, 1e-3, 1e-5   # phase 6's fixed floors
FLOOR_X = 3.0
F64_RTOL, F64_HW = 1e-6, 160      # phase 6's float64 rule, the crop
TIMED_STEPS = 4
CLS_BATCH, CLS_SIZE = 32, 224
ROI_3D = (160, 160, 64)


@contextmanager
def f32_deterministic() -> Iterator[None]:
    """TF32 off and cuDNN deterministic inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def ulp_moved(x: torch.Tensor) -> torch.Tensor:
    """Every element of ``x`` moved by one f32 ulp, up or down (seeded)."""
    up = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) < 0.5
    return torch.nextafter(x, torch.where(up, torch.inf, -torch.inf).to(x))


def _rel(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
         ) -> Dict[str, float]:
    """Per tensor: max |got - want| / max |want|."""
    return {n: float((got[n].double() - w.double()).abs().max())
            / (float(w.double().abs().max()) + 1e-30)
            for n, w in want.items()}


def _norm(d: Dict[str, torch.Tensor]) -> float:
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in d.values())))


def ulp_rule(dp: dict, one: dict, moved: dict, what: str) -> dict:
    """``dp`` against ``one``: the loss, and for each group of tensors the
    worst and the median over its tensors of ``max|d| / max|ref|`` and its
    global norm's ratio, each held to FLOOR_X times the same of ``moved``
    (one rank, input moved by an ulp) against ``one``, or to its fixed
    tolerance where that is larger (phase 6's rule; the median and the
    norm catch a systematic fault that the worst tensor's floor, set by
    tensors whose gradient is rounding noise, would hide). Raises on a
    miss."""
    out = {"loss_one_rank": one["loss"], "loss_ranks": dp["loss"]}
    loss_floor = abs(moved["loss"] - one["loss"]) / abs(one["loss"])
    out["loss_rel_err"] = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    out["loss_tol"] = max(LOSS_RTOL, FLOOR_X * loss_floor)
    misses = ["loss"] if out["loss_rel_err"] > out["loss_tol"] else []
    for part, base in (("grads", GRAD_RTOL), ("stats", BN_RTOL),
                       ("logits", GRAD_RTOL)):
        if part not in one:
            continue
        rel = _rel(dp[part], one[part])
        flo = _rel(moved[part], one[part])
        ref = _norm(one[part])
        worst = max(rel, key=rel.get)
        r = {"worst_rel_to_max": rel[worst], "worst": worst,
             "floor_one_ulp": max(flo.values()),
             "median_rel_to_max": float(np.median(list(rel.values()))),
             "median_floor_one_ulp": float(np.median(list(flo.values()))),
             "norm_rel_err": abs(_norm(dp[part]) / ref - 1.0),
             "norm_floor_one_ulp": abs(_norm(moved[part]) / ref - 1.0),
             "tensors": len(rel)}
        for key, floor in (("worst_rel_to_max", "floor_one_ulp"),
                           ("median_rel_to_max", "median_floor_one_ulp"),
                           ("norm_rel_err", "norm_floor_one_ulp")):
            tol = max(base, FLOOR_X * r[floor])
            r[key.replace("rel_to_max", "tol").replace("rel_err", "tol")] = tol
            if r[key] > tol:
                misses.append(f"{part}.{key}")
        out[part] = r
    if misses:
        raise AssertionError(f"{what}: {RANKS} ranks vs 1 rank missed "
                             f"{misses}: {out}")
    return out


def f64_rule(dp: dict, one: dict, what: str) -> dict:
    """Float64 ``dp`` against ``one``: the loss relative, and each
    gradient and BN statistic relative to its tensor's max, within
    F64_RTOL. Raises on a miss."""
    out = {"loss_rel_err": abs(dp["loss"] - one["loss"]) / abs(one["loss"]),
           "tol": F64_RTOL}
    misses = ["loss"] if out["loss_rel_err"] > F64_RTOL else []
    for part in ("grads", "stats"):
        rel = _rel(dp[part], one[part])
        worst = max(rel, key=rel.get)
        out[part] = {"worst_rel_to_max": rel[worst], "worst": worst,
                     "tensors": len(rel)}
        misses += [part] if rel[worst] > F64_RTOL else []
    if misses:
        raise AssertionError(f"{what}: {RANKS} ranks vs 1 rank missed "
                             f"{misses}: {out}")
    return out


def fixed_rule(dp: dict, one: dict, what: str) -> dict:
    """``dp`` against ``one`` without an ulp floor: the loss within
    LOSS_RTOL relative; for each group of tensors the median over its
    tensors of ``max|d| / max|ref|`` and the global norm's ratio within
    GRAD_RTOL; the worst tensor reported. Raises on a miss."""
    out = {"loss_one_rank": one["loss"], "loss_ranks": dp["loss"],
           "loss_rel_err": abs(dp["loss"] - one["loss"]) / abs(one["loss"]),
           "loss_tol": LOSS_RTOL, "tol": GRAD_RTOL}
    misses = ["loss"] if out["loss_rel_err"] > LOSS_RTOL else []
    for part in ("grads", "logits"):
        if part not in one:
            continue
        rel = _rel(dp[part], one[part])
        worst = max(rel, key=rel.get)
        r = {"worst_rel_to_max": rel[worst], "worst": worst,
             "median_rel_to_max": float(np.median(list(rel.values()))),
             "norm_rel_err": abs(_norm(dp[part]) / _norm(one[part]) - 1.0),
             "tensors": len(rel)}
        misses += [f"{part}.{k}" for k in ("median_rel_to_max",
                                           "norm_rel_err")
                   if r[k] > GRAD_RTOL]
        out[part] = r
    if misses:
        raise AssertionError(f"{what}: {RANKS} ranks vs 1 rank missed "
                             f"{misses}: {out}")
    return out


def _cpu(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in d.items()}


# ---------------------------------------------------------------------------
# The steps, on a group or on one rank
# ---------------------------------------------------------------------------

def _unet(seed: int, dev: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    return init_weights(build_unet("unet", "resnet34", in_ch=1, classes=1),
                        torch.Generator().manual_seed(seed)).to(dev, dtype)


def _engine(model: torch.nn.Module, group: Optional[DataGroup]) -> Engine:
    return Engine(model, LossManager(classes=1, name="dice_bce"),
                  make_optimizer(model.parameters(), 1e-3, 1e-4, 5.0),
                  classes=1, aug="light", group=group)


def unet_step(dev: torch.device, x: torch.Tensor, y: torch.Tensor,
              group: Optional[DataGroup] = None,
              dtype: torch.dtype = torch.float32) -> dict:
    """One ``grads_one`` of the global batch ``x``, ``y`` in ``dtype``."""
    model = _unet(7, dev, dtype)
    eng = _engine(model, group)
    loss, grads = eng.grads_one(x.to(dev, dtype), y.to(dev),
                                torch.Generator(device=dev).manual_seed(11))
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss), "grads": _cpu(dict(zip(names, grads))),
            "stats": _cpu({n: b for n, b in model.named_buffers()
                           if n.endswith(("running_mean", "running_var"))})}


def classifier_step(dev: torch.device, x: torch.Tensor, y: torch.Tensor,
                    group: Optional[DataGroup] = None) -> dict:
    """One train step of ConvNeXt base (f32, SGD at lr 1: the update is the
    gradient) on the global batch ``x``, ``y``."""
    class Split:
        weights = (1.0, 1.0)

    with tempfile.TemporaryDirectory(prefix="probe_dp_clf_") as td:
        tr = ClassifierTrainer(
            ClassifierArgs(out_dir=td, model="convnext", amp=False,
                           optimizer="sgd", lr=1.0, momentum=0.9, seed=15,
                           data_parallel=group.world if group else 1),
            Split(), Split(), device=dev, group=group)
        before = {n: p.detach().clone()
                  for n, p in tr.model.named_parameters()}
        loss, logits = tr.train_step(x.to(dev), y.to(dev))
        update = {n: before[n] - p.detach()
                  for n, p in tr.model.named_parameters()}
    return {"loss": float(loss), "grads": _cpu(update),
            "logits": {"logits": logits.detach().float().cpu()}}


def unet3d_step(dev: torch.device, list_txt: str, out_dir: str,
                group: Optional[DataGroup] = None) -> dict:
    """``UNet3DTrainer.grads_one`` at the reference width on the first host
    batch of 2 patches."""
    args = UNet3DArgs(train_list=list_txt, val_list=list_txt,
                      out_dir=out_dir, roi=ROI_3D, batch_size=2, amp=False,
                      samples_per_vol_train=2, samples_per_vol_val=1,
                      data_parallel=group.world if group else 1)
    tr = UNet3DTrainer(args, dev, group)
    loss, grads = tr.grads_one(*tr._to_device(*next(tr._train_batches())))
    names = [n for n, _ in tr.model.named_parameters()]
    return {"loss": float(loss), "grads": _cpu(dict(zip(names, grads)))}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn, n: int) -> float:
    """ms a call of ``fn`` over ``n`` calls after one warm-up, the host
    clock around synchronized calls."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def _trainer_args(train_list: str, val_list: str, out_dir: str,
                  world: int) -> UNet2DArgs:
    return UNet2DArgs(train_list=train_list, val_list=val_list,
                      out_dir=out_dir, epochs=1, batch_size=GLOBAL_BATCH,
                      aug="light", amp=False, workers=0, seed=2024,
                      data_parallel=world, store_sharded=world > 1)


def _files(d: str):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*"))


def _step_losses(d: str):
    import csv
    with open(os.path.join(d, "history_step.csv"), newline="") as f:
        return [float(r["train_loss_step"]) for r in csv.DictReader(f)]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def rank_main(group: DataGroup, train_list: str, val_list: str, work: str,
              x, y, xc, yc) -> dict:
    """Every data-parallel check on this rank; rank 0 also runs each
    one-rank reference (the other rank waits at its next collective)."""
    dev, lead = group.device, group.primary
    x, y, xc, yc = (torch.from_numpy(a) for a in (x, y, xc, yc))
    res = {"started": time.time(), "ranks": group.world,
           "backend": group.backend}
    clock = [time.perf_counter()]
    seconds = res["part_seconds"] = {}

    def mark(part: str) -> None:
        clock.append(time.perf_counter())
        seconds[part] = clock[-1] - clock[-2]
    with f32_deterministic():
        dp = unet_step(dev, x, y, group)
        if lead:
            res["step"] = ulp_rule(dp, unet_step(dev, x, y),
                                   unet_step(dev, ulp_moved(x), y),
                                   "U-Net step")
        c = (x.shape[-1] - F64_HW) // 2
        x64 = x[..., c:c + F64_HW, c:c + F64_HW]
        y64 = y[..., c:c + F64_HW, c:c + F64_HW]
        dp = unet_step(dev, x64, y64, group, torch.float64)
        if lead:
            res["step_f64"] = f64_rule(dp, unet_step(
                dev, x64, y64, dtype=torch.float64), "float64 U-Net step")
            res["step_f64"]["batch"] = list(x64.shape)
        del dp
        mark("step")
        src = SliceStore.from_files(read_list(train_list)
                                    + read_list(val_list))
        perm = epoch_permutation(torch.Generator(device=dev).manual_seed(3),
                                 len(src), GLOBAL_BATCH)[:2]
        runs = []
        for shard in (False, True):
            store = src.to_device(1, torch.float32, dev, group=group,
                                  shard=shard)
            eng = _engine(_unet(7, dev), group)
            losses = eng.train_steps(store, perm, torch.Generator(
                device=dev).manual_seed(5)).cpu()
            runs.append((losses, [p.detach().clone() for p in eng.params]))
        eq = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        if not eq:
            raise AssertionError("sharded store steps differ from the "
                                 "replicated store's")
        res["stores"] = {"steps": len(perm), "losses": runs[0][0].tolist(),
                         "bit_equal": eq}
        del runs
        mark("stores")
        store = src.to_device(1, torch.float32, dev, group=group)
        eng = _engine(_unet(7, dev), group)
        gen = torch.Generator(device=dev).manual_seed(5)
        row = perm[:1]
        ms_dp = _timed(dev, lambda: eng.train_steps(store, row, gen),
                       TIMED_STEPS)
        _, grads = eng._local_grads(*gather_batch(store, row[0]), gen)
        flat = grads + [torch.zeros((), device=dev)]
        ms_ar = _timed(dev, lambda: average_flat(flat, group), TIMED_STEPS)
        n_bytes = 4 * sum(g.numel() for g in flat)
        del eng, grads, flat
        res["timing"] = {"ms_step_ranks": ms_dp, "ms_allreduce": ms_ar,
                         "allreduce_bytes": n_bytes,
                         "steps_timed": TIMED_STEPS}
        barrier(group)
        if lead:
            one = _engine(_unet(7, dev), None)
            res["timing"]["ms_step_one_rank"] = _timed(
                dev, lambda: one.train_steps(store, row, gen), TIMED_STEPS)
            del one
        barrier(group)
        mark("timing")

        val = SliceStore.from_list(val_list)
        vstore = val.to_device(1, torch.float32, dev, group=group)
        eng = _engine(_unet(7, dev), group)
        got = eng.validate_volume_sharded(vstore, [len(val) // 2,
                                                   len(val) - len(val) // 2],
                                          group.world, 4)
        if lead:
            alone = _engine(_unet(7, dev), None)
            want = alone.validate_volume_sharded(
                vstore, [len(val) // 2, len(val) - len(val) // 2],
                group.world, 4)
            if not np.array_equal(got[2], want[2]):
                raise AssertionError(f"volume-sharded Dice {got[2]} != one "
                                     f"rank's {want[2]}")
            res["volume_sharded"] = {"per_vol_dice": got[2].tolist(),
                                     "one_rank": want[2].tolist()}
        del eng
        mark("volume_sharded")

        dp_dir = os.path.join(work, "trainer_dp")
        hist = UNet2DTrainer(_trainer_args(train_list, val_list, dp_dir,
                                           group.world),
                             dev, group).run()["history"]
        if lead:
            one_dir = os.path.join(work, "trainer_one")
            UNet2DTrainer(_trainer_args(train_list, val_list, one_dir, 1),
                          dev).run()
            a, b = _step_losses(one_dir), _step_losses(dp_dir)
            out = {"files_equal": _files(dp_dir) == _files(one_dir),
                   "files": len(_files(dp_dir)), "step_losses_one": a,
                   "step_losses_ranks": b, "val_dice": hist[0]["val_dice"]}
            if (not out["files_equal"] or len(a) != len(b)
                    or abs(a[0] - b[0]) > res["step"]["loss_tol"] * abs(
                        a[0])):
                raise AssertionError(f"trainer run on {group.world} ranks "
                                     f"vs 1: {out}")
            res["trainer"] = out
        barrier(group)
        mark("trainer")

        dp = classifier_step(dev, xc, yc, group)
        if lead:
            res["classifier"] = fixed_rule(dp, classifier_step(dev, xc, yc),
                                           "classifier step")
        del dp
        barrier(group)
        mark("classifier")
        dp = unet3d_step(dev, train_list, os.path.join(work, "u3d_dp"),
                         group)
        if lead:
            res["unet3d"] = fixed_rule(dp, unet3d_step(
                dev, train_list, os.path.join(work, "u3d_one")), "3-D step")
        del dp
        barrier(group)
        mark("unet3d")
    return res


def rank_args(train_list: str, val_list: str, work: str) -> tuple:
    """The arguments of :func:`rank_main` after the group: the lists, a
    work directory, the U-Net's global batch (the train pack's first
    slices) and the classifier's (seeded)."""
    src = SliceStore.from_list(train_list)
    rng = np.random.default_rng(15)
    return (train_list, val_list, work,
            src.images[:GLOBAL_BATCH, None].copy(),
            src.masks[:GLOBAL_BATCH].astype(np.uint8),
            rng.standard_normal((CLS_BATCH, 1, CLS_SIZE, CLS_SIZE)).astype(
                np.float32),
            (np.arange(CLS_BATCH) % 2).astype(np.float32))


def probe(dev: torch.device, train_list: str, val_list: str,
          work: str) -> dict:
    """The checks of the module docstring on ``RANKS`` ranks sharing
    ``dev``; raises on a miss."""
    if dev.type != "cuda":
        raise ValueError("probe_data_parallel measures ranks on a card")
    t0, wall = time.perf_counter(), time.time()
    card = torch.device("cuda", dev.index or 0)
    res = spawn(rank_main, RANKS, [card] * RANKS, timeout_s=600.0,
                args=rank_args(train_list, val_list, work))[0]
    res["seconds"] = time.perf_counter() - t0
    res["part_seconds"]["spawn_to_rank_start"] = res.pop("started") - wall
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="chiprun_out/probe_dp.json")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from ..data.packer import pack_kspace_volume
    from ..data.preprocess import MRIKneePreprocessor
    from ..utils.synthetic import synthetic_kspace_pairs
    dev = torch.device(a.device)
    with tempfile.TemporaryDirectory(prefix="probe_dp_") as tmp:
        pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.3, 0.7),
                                  device=dev)
        lists = []
        for i in range(2):
            pack_kspace_volume(pre, synthetic_kspace_pairs(
                seed=i, s=35, h=640, w=368), os.path.join(tmp, f"vol{i}"))
            lst = os.path.join(tmp, f"list{i}.txt")
            Path(lst).write_text(os.path.join(tmp, f"vol{i}", "volume.npz"))
            lists.append(lst)
        res = probe(dev, lists[0], lists[1], tmp)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
