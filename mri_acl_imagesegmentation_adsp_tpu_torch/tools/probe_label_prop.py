"""Can an on-chip, iterate-to-convergence propagation beat the plain one?

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_label_prop
        [--out FILE.json]

The counterpart of ``scripts/probe_pallas_roll.py``. On the probe's input,
one ``(320, 320)`` float32 image with a mask of density 0.6 and values
``(index + 1) * mask``, made from seed 0:

- ``masked_max_prop``: 128 steps of ``v = where(mask > 0, max(v, max of
  the 4 circular neighbours), v)``, the CUDA kernel (all steps in one
  launch) against its plain PyTorch loop, bit-equal, each timed cold and
  warm with ``utils/cuda_timing.py`` (the host out of the window), beside
  the operations bound and the serial floors of one SM and of the
  cluster's SMs; the CUDA kernels a call launches (a profiler trace); and
  the kernel warm at 0, ``halo``, ``2 * halo`` and 128 steps, which splits
  its time into set-up, steps and halo exchanges;
- ``label_components``: the same mask's exact 4-connected labels, the
  kernels against the plain sweeps, bit-equal, cold and warm, the sweeps
  the plain version takes and its time (it reads a flag back each sweep,
  so it is timed by the host clock around a synchronize).

Prints the card's ``nvidia-smi`` line and one JSON line, and writes the line
to ``--out``. Exits non-zero without a card or when a result differs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import components
from ..utils.cuda_timing import cuda_ms, kernel_trace

SHAPE = (320, 320)
ITERS = 128
OPS_PER_PIXEL_STEP = 6       # 4 neighbour maxima, the max with v, a select
F32_OPS_PER_S = 33.5e12      # H100 SXM non-FMA float32: half of 67 TFLOP/s
SM_F32_OPS_PER_S = 128 * 1.98e9   # one SM: 128 float32 lanes at boost
HBM_BYTES_PER_S = 3.35e12


def probe_input(dev) -> tuple:
    rng = np.random.default_rng(0)
    mask = (rng.random(SHAPE) > 0.4).astype(np.float32)
    x = (np.arange(SHAPE[0] * SHAPE[1], dtype=np.float32).reshape(SHAPE)
         + 1) * mask
    return torch.from_numpy(mask).to(dev), torch.from_numpy(x).to(dev)


def prop_bound() -> dict:
    """The least time for the probe's 128 steps: operations at the card's
    non-FMA float32 rate against the bytes (mask and x in, v out), and the
    floors of the dependent steps run on one SM and on the cluster's
    ``PROP_CLUSTER`` SMs."""
    ops = ITERS * SHAPE[0] * SHAPE[1] * OPS_PER_PIXEL_STEP
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bytes_ms = 3 * 4 * SHAPE[0] * SHAPE[1] / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations": ops,
            "serial_floor_one_sm_ms": ops / SM_F32_OPS_PER_S * 1e3,
            "serial_floor_cluster_ms": ops / (
                components.PROP_CLUSTER * SM_F32_OPS_PER_S) * 1e3}


def host_ms(fn, runs: int = 5) -> float:
    """Median milliseconds of ``fn`` by the host clock, a synchronize on
    each side: for work that reads back from the card inside."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def _warm_ms_by_iters(mask, x) -> dict:
    """The kernel warm at 0, ``halo``, ``2 * halo`` and ``ITERS`` steps,
    which splits its time into set-up, steps and halo exchanges."""
    k = components.prop_plan(*SHAPE)["halo"]
    return {n: cuda_ms(lambda: components.masked_max_prop(  # noqa: B023
        mask, x, n), cold=False)["ms"] for n in (0, k, 2 * k, ITERS)}


def probe(dev) -> dict:
    """The probe's numbers on ``dev``; raises when a kernel differs from
    its plain version."""
    mask, x = probe_input(dev)
    got = components.masked_max_prop(mask, x, ITERS)
    want = components.masked_max_prop_reference(mask, x, ITERS)
    if not torch.equal(got, want):
        raise AssertionError("masked_max_prop differs from the plain loop: "
                             f"{int((got != want).sum())} pixels")
    kernel = lambda: components.masked_max_prop(mask, x, ITERS)  # noqa: E731
    plain = lambda: components.masked_max_prop_reference(  # noqa: E731
        mask, x, ITERS)
    timers = {"cold": cuda_ms(kernel, cold=True),
              "warm": cuda_ms(kernel, cold=False),
              "plain": cuda_ms(plain, cold=True, iters=10)}
    by_iters = _warm_ms_by_iters(mask, x)
    m8 = (mask > 0).to(torch.uint8)[None]
    lbl = components.label_components(m8)
    want_lbl, sweeps = components.label_components_reference(
        m8, return_sweeps=True)
    if not torch.equal(lbl, want_lbl):
        raise AssertionError("label_components differs from the plain "
                             "sweeps on the probe's mask")
    labels = lambda: components.label_components(m8)  # noqa: E731
    cc = {"cold": cuda_ms(labels, cold=True),
          "warm": cuda_ms(labels, cold=False),
          "plain_ms": host_ms(
              lambda: components.label_components_reference(m8))}
    plan = components.prop_plan(*SHAPE)
    return {"shape": list(SHAPE), "iters": ITERS, "bit_equal": True,
            "plan": plan, "ms": timers["cold"]["ms"],
            "warm_ms": timers["warm"]["ms"],
            "plain_ms": timers["plain"]["ms"], **kernel_trace(kernel),
            "us_per_step": timers["warm"]["ms"] * 1e3 / ITERS,
            **prop_bound(), "timers": timers,
            "warm_ms_by_iters": by_iters,
            "label_components_on_the_mask": {
                "components": int((lbl == torch.arange(
                    lbl.numel(), device=dev).view_as(lbl)).sum()),
                "plain_sweeps": int(sweeps[0]),
                "cold_ms": cc["cold"]["ms"], "warm_ms": cc["warm"]["ms"],
                "plain_ms": cc["plain_ms"],
                "timers": {"cold": cc["cold"], "warm": cc["warm"]}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_label_prop needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    line = json.dumps(probe(torch.device("cuda")))
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
