"""Model parallelism by point-to-point exchange on one card: the
depth-sharded 3-D U-Net, ``cli.infer --ckpt3d --spatial-parallel`` and
VarNet's cascade pipeline on ranks that share the card over gloo, against
one rank, with the checks that decide them.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_model_parallel \\
        --train-list lists/train.txt --ckpt3d runs/unet3d/best3d.ckpt \\
        --infer-list lists/val.txt --out probe_mp.json

Run alone, the tool spawns its two ranks; ``chip_smoke.py`` phase 15 runs
the parts below in the ranks it starts for the data-parallel checks (a
rank's start on the card costs some 20 s of CUDA set-up). Rank 0 also
computes each one-rank reference, in its own process, and compares:

- :func:`unet3d_part`, the reference 3-D U-Net (channels (32, 64, 128, 256,
  320)) at its ROI 160x160x64 and batch 2 on a ``(1, 2)`` (data, depth)
  grid, each rank holding 32 of the 64 planes, through
  ``UNet3DTrainer.grads_one`` (weights from one seed on every rank):
  - ``forward``: the f32 logits of the step below (TF32 off, cuDNN
    deterministic; the InstanceNorms keep no running statistics, so the
    train and eval forwards are one function) gathered from the bands
    against one rank: ``max|d| / max|logit|`` within ``TOL`` or ``FLOOR_X``
    times the one-rank forward's own distance when its input moves by one
    f32 ulp, whichever is larger;
  - ``f32``: one training step's loss and gradients, each gradient's
    distance by norm relative to its own (the dry run's measure), the
    worst and the median within ``DRIFT_TOL`` or ``FLOOR_X`` times the
    same of the one-ulp step; the loss by the same rule. The conv biases
    that an InstanceNorm follows have a zero gradient up to rounding and
    are reported apart (their largest element against the net's largest
    gradient);
  - ``f64``: the step in float64 at a narrow width (channels (8, 16, 32,
    64, 80), 64x64x64): every other gradient and the loss within
    ``F64_RTOL`` of its tensor's max;
  - ``timing``: ms a bf16 step (``amp``: forward, DiceCE, backward, the
    gradient average, AdamW) on the grid and on one rank, the host clock
    around synchronized steps; the halo sends and their bytes a step
    (``parallel/mesh.py:P2P_COUNTS``), the all-reduces over the depth
    ranks a step (the InstanceNorms' sums, twice each, the forward's and
    the recompute's, and the loss's) and the peak GiB a rank.
- :func:`infer3d_part`: ``cli.infer --ckpt3d --spatial-parallel``'s rank on
  a checkpoint and a volume list; rank 0 then runs the one-rank CLI with
  its probabilities, and the masks must be equal except at voxels whose
  one-rank probability lies within ``MASK_MARGIN`` of the threshold
  (counted); seconds a run each way, each writing its probabilities.
- :func:`varnet_pp_part`: the protocol VarNet (10 cascades, ``chans`` 20)
  on a pipe of the ranks, a batch of two validation slices as two
  microbatches, through ``VarNetTrainer(pipe_mesh=)``:
  - ``f32``: one step's loss and gradients against one rank, by the same
    drift rule, the floor the one-rank step with each non-zero k-space
    sample moved by one f32 ulp (the zeros stay: they are the sampling
    mask; the pipe runs each cascade on one sample where one rank runs it
    on two, so its kernels may sum in another order, noise of the size a
    one-ulp move shows);
  - ``timing``: ms a bf16 step on the pipe and on one rank, the sends and
    their bytes a step, and the bubble share ``(S - 1) / (M + S - 1)``.

A failed check raises. Needs a CUDA card, or ``--device cpu`` to debug.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..cli import infer
from ..models.factory import build_unet3d
from ..models.unet3d import init_weights3d
from ..parallel import mesh
from ..parallel.mesh import DataGroup, average_flat, barrier
from ..parallel.spatial import (band_for, depth_sharded, gather_depth,
                                make_depth_mesh)
from ..train.losses import dice_ce_loss_3d_binary
from ..train.trainer3d import UNet3DArgs, UNet3DTrainer
from ..train.varnet_trainer import VarNetArgs, VarNetTrainer
from ..utils.device import f32_on_card
from . import varnet_synthetic
from .probe_data_parallel import f32_deterministic, ulp_moved

RANKS = 2
SEED = 17
CHANNELS, ROI, BATCH = (32, 64, 128, 256, 320), (160, 160, 64), 2
NARROW, NARROW_ROI = (8, 16, 32, 64, 80), (64, 64, 64)
TOL, DRIFT_TOL, FLOOR_X = 1e-5, 1e-3, 3.0
F64_RTOL = 1e-10
MASK_MARGIN = 0.05          # of the probability, around the threshold
WARMUP, TIMED = 1, 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev: torch.device) -> float:
    """ms a call of ``fn`` after WARMUP calls, the host clock around
    TIMED synchronized calls."""
    for _ in range(WARMUP):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / TIMED * 1e3


def _zero_grad(name: str) -> bool:
    """A conv bias that an InstanceNorm follows: its gradient is zero."""
    return ".convs." in name and name.endswith(".bias")


def _drift(got: dict, want: dict) -> Dict[str, float]:
    return {n: float((got[n] - w).norm() / (w.norm() + 1e-30))
            for n, w in want.items() if n != "loss" and not _zero_grad(n)}


def drift_rule(got: dict, want: dict, floor_run: dict, what: str) -> dict:
    """``got`` against ``want`` (one rank), ``floor_run`` (one rank, the
    floor's perturbation) setting the floor: the loss's relative
    distance, and each gradient's distance by norm, worst and median;
    raises on a miss."""
    drift, floor = _drift(got, want), _drift(floor_run, want)
    loss = float(want["loss"])
    out = {"loss": loss,
           "loss_rel_diff": abs(float(got["loss"]) - loss) / abs(loss),
           "loss_floor": abs(float(floor_run["loss"]) - loss) / abs(loss),
           "grad_worst_drift": max(drift.values()),
           "grad_worst_tensor": max(drift, key=drift.get),
           "grad_median_drift": float(np.median(list(drift.values()))),
           "floor_worst_drift": max(floor.values()),
           "floor_median_drift": float(np.median(list(floor.values()))),
           "grad_tensors": len(drift), "drift_tol": DRIFT_TOL,
           "floor_x": FLOOR_X}
    top = max(float(w.abs().max()) for n, w in want.items() if n != "loss")
    zero = [n for n in want if _zero_grad(n)]
    if zero:
        out["zero_grad_tensors"] = len(zero)
        out["zero_grad_max_rel_to_net_max"] = max(
            float(got[n].abs().max()) for n in zero) / top
    out["loss_tol"] = max(TOL, FLOOR_X * out["loss_floor"])
    out["worst_tol"] = max(DRIFT_TOL, FLOOR_X * out["floor_worst_drift"])
    out["median_tol"] = max(DRIFT_TOL, FLOOR_X * out["floor_median_drift"])
    if (out["loss_rel_diff"] > out["loss_tol"]
            or out["grad_worst_drift"] > out["worst_tol"]
            or out["grad_median_drift"] > out["median_tol"]):
        raise AssertionError(f"{what} f32 step vs one rank: {out}")
    return out


def f64_rule(got: dict, want: dict, what: str) -> dict:
    """Every tensor (the loss among them; not the zero-gradient biases)
    within F64_RTOL of its max."""
    rel = {n: float((got[n] - w).abs().max() / (w.abs().max() + 1e-300))
           for n, w in want.items() if not _zero_grad(n)}
    worst = max(rel, key=rel.get)
    out = {"f64_worst_rel_to_max": rel[worst], "f64_worst_tensor": worst,
           "f64_median_rel_to_max": float(np.median(list(rel.values()))),
           "f64_tol": F64_RTOL}
    if rel[worst] > F64_RTOL:
        raise AssertionError(f"{what} float64 step vs one rank: {out}")
    return out


def _named(model: torch.nn.Module, loss, grads) -> Dict[str, torch.Tensor]:
    out = {n: g.detach().double().cpu()
           for (n, _), g in zip(model.named_parameters(), grads)}
    out["loss"] = loss.detach().double().cpu()
    return out


# ---------------------------------------------------------------------------
# The depth-sharded 3-D U-Net
# ---------------------------------------------------------------------------

def _trainer3d(train_list: str, work: str, amp: bool, dev: torch.device,
               group: Optional[DataGroup]) -> UNet3DTrainer:
    args = UNet3DArgs(train_list=train_list, val_list=train_list,
                      out_dir=os.path.join(work, "mp3d"), roi=ROI,
                      channels=CHANNELS, batch_size=BATCH, epochs=1,
                      amp=amp, samples_per_vol_train=1,
                      samples_per_vol_val=1, seed=SEED,
                      spatial_parallel=group.world if group else 1)
    return UNet3DTrainer(args, dev, group)


def _batch3d(dev: torch.device, shape=ROI) -> tuple:
    """A seeded patch batch ``(BATCH, 1, D, Y, X)`` and its labels."""
    yy, xx, dd = shape
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, 1, dd, yy, xx), generator=g)
    y = (torch.rand((BATCH, dd, yy, xx), generator=g) > 0.7).long()
    return x.to(dev), y.to(dev)


def _step_and_logits(tr: UNet3DTrainer, x: torch.Tensor, y: torch.Tensor
                     ) -> tuple:
    """``tr.grads_one(x, y)``'s loss and gradients by name, and the
    logits of its forward (gathered from the bands on a grid)."""
    seen = []
    hook = tr.model.register_forward_hook(
        lambda m, i, o: seen.append(o.detach()))
    try:
        loss, grads = tr.grads_one(x, y)
    finally:
        hook.remove()
    logits = seen[0]
    _, band, bands = band_for(x, tr.depth, tr.unit)
    if band is not None:
        logits = gather_depth(logits, bands, tr.depth)
    return logits, _named(tr.model, loss, grads)


def _forward_rule(got: torch.Tensor, want: torch.Tensor,
                  moved: torch.Tensor) -> dict:
    top = float(want.abs().max())
    out = {"rel_to_max": float((got - want).abs().max()) / top,
           "floor_one_ulp": float((moved - want).abs().max()) / top,
           "logits_max": top, "shape": list(got.shape)}
    out["tol"] = max(TOL, FLOOR_X * out["floor_one_ulp"])
    if out["rel_to_max"] > out["tol"]:
        raise AssertionError(f"depth-sharded 3-D forward vs one rank: {out}")
    return out


def _f64_grads(grid, x, y, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The narrow float64 step on ``grid`` (None: one rank)."""
    m = init_weights3d(build_unet3d(1, 1, NARROW, dtype=torch.float64),
                       torch.Generator().manual_seed(SEED))
    m = m.to(dev, torch.float64).train()
    x, y = x.to(dev, torch.float64), y.to(dev, torch.float64)
    unit = 2 ** (len(NARROW) - 1)
    xb, band, _ = band_for(x, grid.depth if grid else None, unit)
    with depth_sharded(m, band):
        yb = y if band is None else y.narrow(1, band.start, band.size)
        loss = dice_ce_loss_3d_binary(m(xb), yb[:, None],
                                      group=band.group if band else None)
        grads = list(torch.autograd.grad(loss, list(m.parameters())))
    if grid is not None:
        *grads, loss = average_flat(grads + [loss.detach()], grid.world)
    return _named(m, loss, grads)


def count_all_reduces(group: DataGroup, fn) -> dict:
    """The all-reduces ``fn()`` makes over ``group``, and their bytes."""
    counts = [0, 0]
    plain = mesh.all_reduce_

    def counting(t, g):
        if g is group:
            counts[0] += 1
            counts[1] += t.numel() * t.element_size()
        return plain(t, g)
    mesh.all_reduce_ = counting
    try:
        fn()
    finally:
        mesh.all_reduce_ = plain
    return {"all_reduces": counts[0], "all_reduce_bytes": counts[1]}


def unet3d_part(group: DataGroup, train_list: str, work: str) -> dict:
    """The 3-D checks of the module docstring on this rank."""
    dev, lead = group.device, group.primary
    res = {"channels": list(CHANNELS), "roi": list(ROI), "batch": BATCH,
           "ranks": group.world, "backend": group.backend}
    seconds = res["part_seconds"] = {}
    t0 = time.perf_counter()
    x, y = _batch3d(dev)
    with f32_deterministic():
        tr = _trainer3d(train_list, work, False, dev, group)
        res["bands"] = [group.world, int(x.shape[2]) // group.world]
        got, step = _step_and_logits(tr, x, y)
        del tr
        if lead:
            one = _trainer3d(train_list, work, False, dev, None)
            want, want_step = _step_and_logits(one, x, y)
            moved, floor = _step_and_logits(one, ulp_moved(x.cpu()).to(dev),
                                            y)
            res["forward"] = _forward_rule(got, want, moved)
            res["f32"] = drift_rule(step, want_step, floor,
                                    "depth-sharded 3-D U-Net")
            del one, want, moved
        del got, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        barrier(group)
        seconds["f32"] = time.perf_counter() - t0
        xn, yn = _batch3d(torch.device("cpu"), NARROW_ROI)
        grid = make_depth_mesh(group, group.world)
        got = _f64_grads(grid, xn, yn, dev)
        if lead:
            res["f64"] = f64_rule(got, _f64_grads(None, xn, yn, dev),
                                  "depth-sharded 3-D U-Net")
            res["f64"].update(channels=list(NARROW), roi=list(NARROW_ROI))
        barrier(group)
        seconds["f64"] = time.perf_counter() - t0 - seconds["f32"]
    t1 = time.perf_counter()
    tr = _trainer3d(train_list, work, True, dev, group)

    def step_fn(t=tr):
        loss, grads = t.grads_one(x, y)
        t.optimizer.step(grads)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timing = res["timing"] = {}
    # every step makes the same exchanges: the timed steps' counts a step
    mesh.reset_p2p_counts()
    counts = count_all_reduces(tr.depth, lambda: timing.update(
        ms_step_grid=_ms(step_fn, dev)))
    timing.update({k: v // (WARMUP + TIMED) for k, v in counts.items()})
    timing["halo_sends"] = mesh.P2P_COUNTS["sends"] // (WARMUP + TIMED)
    timing["halo_bytes"] = mesh.P2P_COUNTS["bytes"] // (WARMUP + TIMED)
    if dev.type == "cuda":
        timing["peak_gib_grid_rank"] = (torch.cuda.max_memory_allocated(dev)
                                        / 2 ** 30)
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    barrier(group)
    if lead:
        one = _trainer3d(train_list, work, True, dev, None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        timing["ms_step_one_rank"] = _ms(
            lambda: one.optimizer.step(one.grads_one(x, y)[1]), dev)
        if dev.type == "cuda":
            timing["peak_gib_one_rank"] = (
                torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del one
    barrier(group)
    seconds["timing"] = time.perf_counter() - t1
    return res


# ---------------------------------------------------------------------------
# cli.infer --ckpt3d --spatial-parallel
# ---------------------------------------------------------------------------

def infer3d_part(group: DataGroup, ckpt3d: str, list_txt: str,
                 work: str) -> dict:
    """``cli.infer --ckpt3d --spatial-parallel``'s rank, then (rank 0) the
    one-rank CLI and the mask rule of the module docstring."""
    dev = group.device
    flags = ["--ckpt3d", ckpt3d, "--list", list_txt, "--metrics",
             "--device", str(dev)]
    shard_dir = os.path.join(work, "infer3d_sharded")
    _sync(dev)
    t0 = time.perf_counter()
    infer.run_3d_rank(group, infer.build_parser().parse_args(
        flags + ["--out-dir", shard_dir, "--save-probs",
                 "--spatial-parallel", str(group.world)]))
    _sync(dev)
    res = {"seconds_sharded": time.perf_counter() - t0}
    if group.primary:
        one_dir = os.path.join(work, "infer3d_one")
        t0 = time.perf_counter()
        if infer.main(flags + ["--out-dir", one_dir, "--save-probs"]) != 0:
            raise AssertionError("the one-rank cli.infer --ckpt3d failed")
        res["seconds_one_rank"] = time.perf_counter() - t0
        res["volumes"] = []
        for one, two in zip(*(json.load(open(os.path.join(d, "summary.json"),
                                             encoding="utf-8"))
                              for d in (one_dir, shard_dir))):
            name = os.path.basename(os.path.dirname(one["volume"]))
            with np.load(os.path.join(one_dir, name, "probs.npz")) as z:
                probs = z["probs"]
            m1 = np.load(os.path.join(one_dir, name, "pred_mask.npy"))
            m2 = np.load(os.path.join(shard_dir, name, "pred_mask.npy"))
            differ = m1 != m2
            near = np.abs(probs - 0.5) < MASK_MARGIN
            v = {"volume": name, "shape": list(m1.shape),
                 "voxels": int(m1.size), "differ": int(differ.sum()),
                 "differ_outside_margin": int((differ & ~near).sum()),
                 "within_margin": int(near.sum()),
                 "margin": MASK_MARGIN,
                 "dice_one_rank": one.get("dice"),
                 "dice_sharded": two.get("dice")}
            if differ.any():
                v["differ_max_abs_p_minus_threshold"] = float(
                    np.abs(probs[differ] - 0.5).max())
            res["volumes"].append(v)
            if v["differ_outside_margin"]:
                raise AssertionError(f"--spatial-parallel masks differ "
                                     f"outside the margin: {v}")
    barrier(group)
    return res


# ---------------------------------------------------------------------------
# VarNet's cascade pipeline
# ---------------------------------------------------------------------------

def protocol_pair() -> tuple:
    """The protocol recipe's args and its first two validation slices."""
    samples, _ = varnet_synthetic.make_samples("protocol", "val")
    return dict(varnet_synthetic.RECIPES["protocol"]["args"]), samples[:2]


def _nonzero_ulp_moved(k: np.ndarray) -> np.ndarray:
    """Each non-zero element of ``k`` moved by one f32 ulp (zeros kept)."""
    t = torch.from_numpy(k)
    return torch.where(t == 0, t, ulp_moved(t)).numpy()


def _varnet_trainer(args: dict, amp: bool, dev: torch.device, work: str,
                    pipe: Optional[DataGroup]) -> VarNetTrainer:
    targs = VarNetArgs(**{**args, "amp": amp, "seed": SEED},
                       out_dir=os.path.join(work, "pp_probe"))
    return VarNetTrainer(targs, pipe_mesh=pipe, device=dev)


def _varnet_grads(tr: VarNetTrainer, batch) -> Dict[str, torch.Tensor]:
    tr._init_if_needed(batch[0].kspace, batch[0].espirit)
    loss, grads = tr.loss_and_grads(*tr.upload_batch(batch))
    return _named(tr.model, loss, grads)


def varnet_pp_part(group: DataGroup, args: dict, pair: list,
                   work: str) -> dict:
    """The pipeline checks of the module docstring on this rank."""
    dev, lead = group.device, group.primary
    n_micro = len(pair)
    res = {"stages": group.world, "cascades": args["num_cascades"],
           "chans": args["chans"], "microbatches": n_micro,
           "bubble_share": (group.world - 1) / (n_micro + group.world - 1),
           "coils": int(pair[0].kspace.shape[0]),
           "hw": list(pair[0].target.shape)}
    t0 = time.perf_counter()
    with f32_deterministic():
        got = _varnet_grads(_varnet_trainer(args, False, dev, work, group),
                            pair)
        if lead:
            one = _varnet_trainer(args, False, dev, work, None)
            moved = [p._replace(kspace=_nonzero_ulp_moved(p.kspace))
                     for p in pair]
            res["f32"] = drift_rule(got, _varnet_grads(one, pair),
                                    _varnet_grads(one, moved),
                                    "pipelined VarNet")
            del one
        del got
        barrier(group)
    res["seconds_f32"] = time.perf_counter() - t0
    tr = _varnet_trainer(args, True, dev, work, group)
    mesh.reset_p2p_counts()
    timing = res["timing"] = {
        "ms_step_pipe": _ms(lambda: tr._step_batch(pair), dev)}
    timing["sends"] = mesh.P2P_COUNTS["sends"] // (WARMUP + TIMED)
    timing["bytes"] = mesh.P2P_COUNTS["bytes"] // (WARMUP + TIMED)
    del tr
    barrier(group)
    if lead:
        one = _varnet_trainer(args, True, dev, work, None)
        timing["ms_step_one_rank"] = _ms(lambda: one._step_batch(pair), dev)
    barrier(group)
    return res


def rank_main(group: DataGroup, train_list: str, ckpt3d: str,
              infer_list: str, args: dict, pair: list, work: str) -> dict:
    """Every part on this rank."""
    res = {"unet3d": unet3d_part(group, train_list, work)}
    if group.device.type == "cuda":
        torch.cuda.empty_cache()
    with f32_on_card(group.device):
        res["infer3d"] = infer3d_part(group, ckpt3d, infer_list, work)
    res["varnet_pp"] = varnet_pp_part(group, args, pair, work)
    return res


def probe(dev: torch.device, train_list: str, ckpt3d: str, infer_list: str,
          work: str) -> dict:
    """The checks on RANKS ranks sharing ``dev`` (or CPU ranks); raises on
    a miss. Rank 0's results."""
    t0 = time.perf_counter()
    args, pair = protocol_pair()
    card = torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev
    res = mesh.spawn(rank_main, RANKS, [card] * RANKS, timeout_s=900.0,
                     args=(train_list, ckpt3d, infer_list, args, pair,
                           work))
    out = res[0]
    out["rank1"] = {k: res[1]["unet3d"]["timing"].get(k) for k in (
        "peak_gib_grid_rank", "halo_sends", "halo_bytes")}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-list", required=True,
                   help="packed volumes (the 3-D trainer's sampler reads "
                        "its first)")
    p.add_argument("--ckpt3d", required=True)
    p.add_argument("--infer-list", required=True)
    p.add_argument("--out", default="probe_mp.json")
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default="probe_mp_work")
    a = p.parse_args(argv)
    res = probe(torch.device(a.device), a.train_list, a.ckpt3d,
                a.infer_list, a.work)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
