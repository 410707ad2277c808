"""VarNet's coil-parallel step on one card: a ``(1, 2)`` grid of ranks that
share it over gloo against one rank, at the protocol configuration, with
the checks that decide it.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_coil_parallel \\
        --out chiprun_out/probe_coil.json

Run alone, the tool spawns its two ranks; ``chip_smoke.py`` phase 15 runs
:func:`rank_main` in the ranks it starts for the data-parallel checks (a
rank's start on the card costs some 20 s of CUDA set-up). The
configuration is ``tools/varnet_synthetic.py``'s protocol recipe (10
cascades, ``chans`` 20, ``sens_chans`` 8, 4 pools) on one of its
validation slices (12 coils, one average, 320x320), the weights drawn
from a seed. Each rank holds 6 of the 12 coils; the two ranks' coil sums
meet in gloo all-reduces through the host. Rank 0 also computes each
one-rank reference, in its own process, and compares:

- ``f32``: one training step's loss and gradients through
  ``VarNetTrainer.loss_and_grads`` (the grid's average), TF32 off and cuDNN
  deterministic: the loss within ``LOSS_TOL``, and each gradient's
  distance by norm relative to its own (the dry run's measure, JAX's
  ``_dryrun_varnet_tp``): the worst and the median each within
  ``DRIFT_TOL`` or ``FLOOR_X`` times the same of the one-rank step's
  distances when its coils come in another order (the two halves swapped:
  the same sums, reordered, as the grid reorders them), whichever is
  larger. From a random init the full-width f32 gradients are mostly
  rounding noise (sums with much cancellation, such as a ``dc_weight``'s
  over all of k-space): any reordering moves them past ``DRIFT_TOL``;
- ``f64``: the same step in float64 on a ``F64_HW`` square centre crop of
  the slice's k-space, maps and target: the loss and every gradient within
  ``F64_RTOL`` of each tensor's max;
- ``timing``: ms a step of the recipe's bf16 trainer (upload, forward,
  SSIM loss, backward, the gradient average, AdamW) on the grid and on one
  rank, the host clock around synchronized steps; the coil all-reduces a
  step and their bytes, and the gradient average's, counted by wrapping
  ``parallel/mesh.py:all_reduce_`` for one step.

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

from ..parallel import mesh
from ..parallel.mesh import DataGroup, ReconGrid, barrier, make_recon_grid
from ..recon.varnet import VarNet
from ..train.varnet_trainer import VarNetArgs, VarNetTrainer, varnet_loss
from . import varnet_synthetic
from .probe_data_parallel import f32_deterministic

RANKS = 2
SEED = 13
LOSS_TOL, DRIFT_TOL = 1e-5, 1e-3      # graft_entry's VarNet dry-run gates
FLOOR_X = 3.0
F64_RTOL, F64_HW = 1e-10, 160
WARMUP, TIMED = 1, 3


def protocol_case() -> tuple:
    """The protocol recipe's args and its first validation slice's arrays
    ``(kspace, espirit, target, max_value)``."""
    samples, _ = varnet_synthetic.make_samples("protocol", "val")
    s = samples[0]
    return (dict(varnet_synthetic.RECIPES["protocol"]["args"]),
            (s.kspace, s.espirit, s.target, np.float32(s.max_value)))


def _sample(case: tuple, hw: int = 0):
    """The slice as a ``VarNetSample``, or its ``hw`` square centre crop."""
    from ..data.transforms import VarNetSample
    k, e, t, mv = case
    if hw:
        a, b = (k.shape[-3] - hw) // 2, (k.shape[-2] - hw) // 2
        k, e = k[..., a:a + hw, b:b + hw, :], e[..., a:a + hw, b:b + hw, :]
        t = t[a:a + hw, b:b + hw]
    return VarNetSample(np.ascontiguousarray(k), np.ascontiguousarray(t),
                        np.ascontiguousarray(e), "probe", 0, float(mv),
                        tuple(t.shape))


def _trainer(args: dict, amp: bool, dev: torch.device, work: str,
             grid: Optional[ReconGrid]) -> VarNetTrainer:
    targs = VarNetArgs(**{**args, "amp": amp, "seed": SEED},
                       out_dir=os.path.join(work, "coil_probe"))
    return VarNetTrainer(targs, mesh=grid, device=dev)


def _grads(tr: VarNetTrainer, sample) -> Dict[str, torch.Tensor]:
    tr._init_if_needed(sample.kspace, sample.espirit)
    loss, grads = tr.loss_and_grads(*tr.upload_batch([sample]))
    names = [n for n, _ in tr.model.named_parameters()]
    out = {n: g.detach().double().cpu() for n, g in zip(names, grads)}
    out["loss"] = loss.detach().double().cpu()
    return out


def _f64_grads(state: dict, args: dict, sample, dev: torch.device,
               grid: Optional[ReconGrid]) -> Dict[str, torch.Tensor]:
    """The step's loss and gradients in float64 (the model built as the
    trainer builds it, the weights ``state``)."""
    m = VarNet(aves=1, sens_aves=1, num_cascades=args["num_cascades"],
               sens_chans=args["sens_chans"], sens_pools=args["sens_pools"],
               chans=args["chans"], pools=args["pools"], dtype=torch.float64,
               mesh=grid)
    m.load_state_dict(state)
    m = m.to(dev, torch.float64).train()
    k, e, t = (torch.from_numpy(a[None]).to(dev, torch.float64)
               for a in (sample.kspace, sample.espirit, sample.target))
    mv = torch.tensor([sample.max_value], dtype=torch.float64, device=dev)
    loss = varnet_loss(m, k, e, t, mv, args["crop"])
    grads = list(torch.autograd.grad(loss, list(m.parameters())))
    if grid is not None:
        *grads, loss = mesh.grid_average(grads + [loss.detach()], grid)
    out = {n: g.cpu() for (n, _), g in zip(m.named_parameters(), grads)}
    out["loss"] = loss.detach().cpu()
    return out


def _drift(got: dict, want: dict) -> Dict[str, float]:
    """Each gradient's distance by norm relative to its own."""
    return {n: float((got[n] - w).norm() / (w.norm() + 1e-8))
            for n, w in want.items() if n != "loss"}


def drift_rule(got: dict, want: dict, swapped: dict) -> dict:
    """The f32 rule of the module docstring: ``got`` (the grid) against
    ``want`` (one rank), with ``swapped`` (one rank, the coils' halves
    swapped) for the floor; raises on a miss."""
    drift, floor = _drift(got, want), _drift(swapped, want)
    worst = max(drift, key=drift.get)
    out = {"loss": float(want["loss"]),
           "loss_abs_diff": abs(float(got["loss"] - want["loss"])),
           "loss_tol": LOSS_TOL, "grad_worst_drift": drift[worst],
           "grad_worst_tensor": worst,
           "grad_median_drift": float(np.median(list(drift.values()))),
           "grad_tensors": len(drift), "drift_tol": DRIFT_TOL,
           "floor_worst_drift": max(floor.values()),
           "floor_median_drift": float(np.median(list(floor.values()))),
           "floor_worst_tensor": max(floor, key=floor.get),
           "worst_tol": max(DRIFT_TOL, FLOOR_X * max(floor.values()))}
    out["median_tol"] = max(DRIFT_TOL, FLOOR_X * out["floor_median_drift"])
    if (out["loss_abs_diff"] > LOSS_TOL
            or out["grad_median_drift"] > out["median_tol"]
            or out["grad_worst_drift"] > out["worst_tol"]):
        raise AssertionError(f"coil-parallel f32 step vs one rank: {out}")
    return out


def coils_swapped(sample):
    """The sample with the two halves of its coils swapped."""
    half = sample.kspace.shape[0] // 2
    return sample._replace(kspace=np.roll(sample.kspace, half, axis=0),
                           espirit=np.roll(sample.espirit, half, axis=0))


def f64_rule(got: dict, want: dict) -> dict:
    """Every tensor (the loss among them) within F64_RTOL of its max."""
    rel = {n: float((got[n] - w).abs().max() / (w.abs().max() + 1e-300))
           for n, w in want.items()}
    worst = max(rel, key=rel.get)
    out = {"f64_worst_rel_to_max": rel[worst], "f64_worst_tensor": worst,
           "f64_median_rel_to_max": float(np.median(list(rel.values()))),
           "f64_loss_rel": rel["loss"], "f64_tol": F64_RTOL,
           "f64_hw": F64_HW}
    if rel[worst] > F64_RTOL:
        raise AssertionError(f"coil-parallel float64 step vs one rank: "
                             f"{out}")
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms_a_step(tr: VarNetTrainer, sample, dev: torch.device) -> float:
    for _ in range(WARMUP):
        tr._step_batch([sample])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        tr._step_batch([sample])
    _sync(dev)
    return (time.perf_counter() - t0) / TIMED * 1e3


def count_all_reduces(grid: ReconGrid, fn) -> dict:
    """The all-reduces ``fn()`` makes over the coil sub-group and over the
    whole grid, and their bytes."""
    counts = {"coil": [0, 0], "grid": [0, 0]}
    plain = mesh.all_reduce_

    def counting(t, group):
        key = ("coil" if group is grid.coil else "grid"
               if group is grid.world else None)
        if key:
            counts[key][0] += 1
            counts[key][1] += t.numel() * t.element_size()
        return plain(t, group)
    mesh.all_reduce_ = counting
    try:
        fn()
    finally:
        mesh.all_reduce_ = plain
    return {"coil_all_reduces": counts["coil"][0],
            "coil_bytes": counts["coil"][1],
            "grid_all_reduces": counts["grid"][0],
            "grid_bytes": counts["grid"][1]}


def rank_main(group: DataGroup, args: dict, case: tuple, work: str) -> dict:
    """The checks of the module docstring on this rank of a ``(1, world)``
    grid; rank 0 also runs each one-rank reference (the other ranks wait
    at their next collective)."""
    grid = make_recon_grid(group, 1, group.world)
    dev, lead = group.device, group.primary
    sample, crop = _sample(case), _sample(case, F64_HW)
    res = {"grid": [1, group.world], "backend": group.backend,
           "coils": int(case[0].shape[0]), "hw": list(case[2].shape)}
    clock = [time.perf_counter()]
    seconds = res["part_seconds"] = {}

    def mark(part: str) -> None:
        clock.append(time.perf_counter())
        seconds[part] = clock[-1] - clock[-2]
    with f32_deterministic():
        tr = _trainer(args, False, dev, work, grid)
        got = _grads(tr, sample)
        state = {k: v.detach().cpu() for k, v in
                 tr.model.state_dict().items()}
        del tr
        if lead:
            one = _trainer(args, False, dev, work, None)
            res["f32"] = drift_rule(got, _grads(one, sample),
                                    _grads(one, coils_swapped(sample)))
            del one
        del got
        barrier(group)
        mark("f32")
        got = _f64_grads(state, args, crop, dev, grid)
        if lead:
            res["f64"] = f64_rule(got, _f64_grads(state, args, crop, dev,
                                                  None))
        del got
        barrier(group)
        mark("f64")
    tr = _trainer(args, args.get("amp", True), dev, work, grid)
    res["timing"] = {"ms_step_grid": _ms_a_step(tr, sample, dev)}
    res["timing"].update(count_all_reduces(
        grid, lambda: tr._step_batch([sample])))
    del tr
    if lead:
        res["timing"]["ms_step_one_rank"] = _ms_a_step(
            _trainer(args, args.get("amp", True), dev, work, None), sample,
            dev)
    barrier(group)
    mark("timing")
    return res


def probe(dev: torch.device, work: str) -> dict:
    """The checks on RANKS ranks sharing ``dev`` (or CPU ranks); raises on
    a miss."""
    t0 = time.perf_counter()
    args, case = protocol_case()
    card = torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev
    res = mesh.spawn(rank_main, RANKS, [card] * RANKS, timeout_s=900.0,
                     args=(args, case, work))[0]
    res["seconds"] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="chiprun_out/probe_coil.json")
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default="chiprun_out/probe_coil_work")
    a = p.parse_args(argv)
    res = probe(torch.device(a.device), a.work)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
