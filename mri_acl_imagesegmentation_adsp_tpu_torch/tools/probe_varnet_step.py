"""Where a VarNet training step's time goes on the card.

One bf16 step of ``train/varnet_trainer.py:VarNetTrainer._step_batch`` at
the protocol configuration (``tools/varnet_synthetic.py``: 10 cascades,
``chans`` 20, 12 coils, one average, 320x320) or at the ``VarNetArgs``
defaults (12 cascades, ``chans`` 18, b50), after warm-up steps:

* ``stages_ms``: the trainer's step split by the host's clock, the card
  synchronized at each stage's end (the step's ``mark`` hook): upload,
  forward + SSIM loss, backward, AdamW;
* ``steps_ms``: the plain step (no synchronize inside) by the host's clock,
  each of ``--steps`` steps ended by a synchronize;
* ``back_to_back_ms``: ms a step over ``--steps`` steps issued back to
  back (``utils/cuda_timing.py:back_to_back_ms``, as ``chip_smoke.py``
  times them);
* ``trace``: ``--steps`` steps under ``torch.profiler`` with CPU and CUDA
  activities: wall seconds, the card's busy milliseconds and idle share,
  CUDA kernel launches, the costliest kernels, and the host's costliest
  operators by self CPU time.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_varnet_step \\
      --config protocol --batch 1 --out probe_varnet.json
"""

from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch

from ..train.varnet_trainer import VarNetArgs, VarNetTrainer
from ..utils.cuda_timing import back_to_back_ms
from ..utils.device import resolve_device
from . import varnet_synthetic

TOP = 12


def _samples(config: str, batch: int) -> tuple:
    """The configuration's args and ``batch`` samples: protocol slices, or
    b50 ones made of three protocol slices each."""
    proto, _ = varnet_synthetic.make_samples("protocol", "val")
    if config == "protocol":
        return (VarNetArgs(out_dir="probe_varnet", **varnet_synthetic.RECIPES[
            "protocol"]["args"]), proto[:batch])
    b50 = [proto[0]._replace(kspace=np.concatenate(
        [s.kspace for s in proto[:3]], axis=1))] * batch
    return VarNetArgs(out_dir="probe_varnet"), b50


def stages(trainer: VarNetTrainer, batch: list) -> dict:
    """One step's stages by the host clock, the card synchronized at each
    stage's end."""
    out = {}
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def mark(stage: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[stage] = (now - last[0]) * 1e3
        last[0] = now
    trainer._step_batch(batch, mark)
    return out


def _name(key: str) -> str:
    key = key.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", key, maxsplit=1)[0].split()[-1].rsplit(
        "::", 1)[-1]


def trace(fn, steps: int) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler`` (CPU and CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels, cpu = {}, []
    for ev in events:
        if ev.device_time_total > 0 and ev.self_cpu_time_total == 0:
            n, us = kernels.get(_name(ev.key), (0, 0.0))
            kernels[_name(ev.key)] = (n + ev.count,
                                      us + ev.device_time_total)
        elif ev.self_cpu_time_total > 0:
            cpu.append((ev.key, ev.count, ev.self_cpu_time_total))
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    cpu.sort(key=lambda c: -c[2])
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "card_busy_ms_per_step": busy_ms / steps,
            "idle_share": max(0.0, 1.0 - busy_ms / 1e3 / wall),
            "kernel_launches_per_step": sum(
                n for n, _ in kernels.values()) / steps,
            "top_kernels": [{"name": n, "launches": c / steps,
                             "ms_per_step": us / 1e3 / steps}
                            for n, (c, us) in top_k],
            "top_host_ops": [{"op": k, "calls": c / steps,
                              "self_cpu_ms_per_step": us / 1e3 / steps}
                             for k, c, us in cpu[:TOP]]}


def probe(dev: torch.device, config: str, batch: int, steps: int,
          warmup: int = 3) -> dict:
    args, samples = _samples(config, batch)
    trainer = VarNetTrainer(args, device=dev)
    for _ in range(warmup):
        trainer._step_batch(samples)
    split = stages(trainer, samples)
    plain = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer._step_batch(samples)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t) * 1e3)
    b2b, _ = back_to_back_ms(lambda: trainer._step_batch(samples), steps)
    return {"config": config, "batch": batch, "stages_ms": split,
            "steps_ms": plain, "back_to_back_ms": b2b,
            "trace": trace(lambda: trainer._step_batch(samples), steps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("VarNet step probe")
    p.add_argument("--config", choices=("protocol", "defaults"),
                   default="protocol")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    dev = resolve_device("cuda")
    out = {"card": torch.cuda.get_device_name(0),
           **probe(dev, a.config, a.batch, a.steps)}
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w", encoding="utf-8") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
