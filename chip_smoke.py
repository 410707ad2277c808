#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the serving daemon's ``/v1/segment_kspace``: raw
single-coil or multi-coil k-space -> iFFT magnitude (per coil, then RSS) ->
percentile clip -> Otsu body mask (its disk(2) open/close in the CUDA kernel
``csrc/open_close.cu``, its connected components in ``csrc/label_prop.cu``)
-> resize and z-score -> ResNet34 U-Net at full width (320x320 input,
decoder 256-128-64-32-16) -> mask. The weights are random, made from a
seed.

Phases, each printing one JSON line with its seconds:
  0  setup: watchdog, the card's name and power limit, TF32 off for the
     parity phases 2-4;
  1  build the CUDA kernels with nvcc (one process a source, started
     together), with what ptxas says of them;
  2  kernel vs its plain PyTorch version on the card, bit-equal at the
     kernel's word and band edges, three densities and misaligned starts;
     at a volume's (35, 640, 368) and a served request's (8, 640, 368)
     shape its cold and warm time with the host out of the window
     (``utils/cuda_timing.py``), the host's time a call, the plain
     version's time, the four-convolution yardstick's, and the bound;
  3  the preprocess chain on a (35, 640, 368, 2) volume, card vs CPU;
  4  the model's logits on a (16, 1, 320, 320) batch, card vs CPU;
  5  the server, started from torch's own precision flags as its command
     line starts it, answering three /v1/segment_kspace requests, each
     checked against the in-process result and shown to launch each mask
     kernel (open_close, label_components) exactly once;
  6  train: pack four synthetic 35-slice volumes with the port's packer
     (one open/close launch each), train two epochs through the launcher
     at full width (batch 8, aug light, bf16 autocast and store, as the
     reference run), serve the best checkpoint back on the val volume;
     one engine step card vs CPU in f32 (loss, every gradient, the BN
     running stats); train slices/s at batch 8 f32, batch 8 bf16 and
     batch 128 bf16 with peak memory;
  7  evaluate and serve the rest: the batch inference CLI on phase 6's val
     list and best checkpoint with --metrics, plain and with --tta hflip;
     evaluate_volume at 35x320x320 card vs CPU (the exact EDT bit-equal,
     HD95 / ASSD against the CPU and a scipy oracle of the reference's
     medimetrics, the no-zero sentinel) and its time per volume; a daemon
     with --tta hflip --microbatch-window-ms 5 at its default batch of 16
     answering eight concurrent 6-slice /v1/segment requests (so a batch
     mixes requests) and one /v1/segment_kspace request (one open/close
     launch), with its /metricsz counts, then that burst timed five times
     each on it and on the same daemon without the window; UNet++ at full width
     (logits card vs CPU, b8 bf16 train slices/s, a checkpoint served
     back); the run report of phase 6's run directory;
  8  the rest of preprocessing: label_components kernel vs its plain sweeps,
     bit-equal at its edge cases (widths across its tiles, H = 1, a
     checkerboard, a 640x368 serpentine of hundreds of sweeps, rings,
     borders) and on phase 3's volume's masks before their components,
     timed at a volume and a request; the probe's masked_max_prop
     (``tools/probe_label_prop.py``) bit-equal and timed; a seeded
     (35, 15, 640, 368, 2) multi-coil volume card vs CPU, its card time and
     peak memory; N4 + NL-means on 4 of its slices card vs CPU, per-slice
     N4 updates compared first; one (4, 15, 640, 368, 2) multi-coil
     /v1/segment_kspace request against the in-process result, launching
     each mask kernel once.
Then a ``kernels`` line, the ``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any mismatch raises and the script exits
non-zero; without a card it exits non-zero and prints no result, and a
watchdog turns a hang into a non-zero exit with a traceback.
"""

from __future__ import annotations

import copy
import csv
import faulthandler
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import infer, launcher, serve
from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
    load_model_from_ckpt)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.hbm_loader import (
    SliceStore, gather_batch)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    SURFACE_CHUNK, evaluate_volume, segment_volume_2d, segment_volumes_2d,
    slice_metrics, threshold_probs)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import edt
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
    _build, components, morphology)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.maskops import (
    open_closed_otsu_mask)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.restoration import (
    n4_bias_correction)
from mri_acl_imagesegmentation_adsp_tpu_torch.report import exporter
from mri_acl_imagesegmentation_adsp_tpu_torch.tools import probe_label_prop
from mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_train_step import (
    grads_f64)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.augment import (
    augment_batch)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
    save_best)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
from mri_acl_imagesegmentation_adsp_tpu_torch.train.losses import (
    LossManager)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
    make_optimizer)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.cuda_timing import (
    cuda_ms, host_us)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    component_masks, synthetic_kspace_pairs, synthetic_multicoil_kspace_pairs)

WATCHDOG_S = 900          # the whole run aims for well under 300 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 132 SMs x 64 lanes x boost
OPS_PER_WORD = 4 * (8 + 12)  # open_close.cu: passes x (shifts + AND/OR)
EDGE_W = (1, 31, 32, 33, 63, 64, 65, 368, 369)
DENSITIES = (0.05, 0.5, 0.95)
VOLUME = (35, 640, 368)   # fastMRI knee single-coil slices x k-space H x W
SERVE_SLICES = 8
MODEL_BATCH = (16, 1, 320, 320)
LOGIT_RTOL = 1e-3          # card vs CPU f32 logits, relative to max|logit|
TENSOR_TOL = 1e-4          # card vs CPU z-scored tensor on equal-mask slices
MASK_DIFF_MAX = 1e-3       # card vs CPU body-mask pixels allowed to differ
TRAIN_VOLUMES = 4          # packed for phase 6: 3 train, 1 val at ratio 0.8
STEP_LOSS_RTOL = 1e-4      # card vs CPU one train step, f32, TF32 off
STEP_GRAD_RTOL = 1e-3      # per gradient tensor, times its max |g|
STEP_GRAD_FLOOR_X = 3.0    # or this many times f32's floor (step_parity)
STEP_GRAD_F64_RTOL = 1e-6  # the same step in float64, per tensor
STEP_BN_RTOL = 1e-5        # BN running stats, relative
THROUGHPUT = (("b8_f32", 8, False), ("b8_bf16", 8, True),
              ("b128_bf16", 128, True))
WARMUP_STEPS, TIMED_STEPS = 3, 20
RUN_FILES = ("args.json", "history_epoch.csv", "history_step.csv",
             "history.json", "summary.json", "metrics.json", "best.ckpt",
             "best.ckpt.args.json")
EVAL_SLICES = 35           # evaluate_volume on the card: a whole volume
EVAL_CPU_SLICES = 8        # of which the CPU and scipy check these
EVAL_SHIFT_PX = 3          # pred = gt shifted along W, then opened
EVAL_RTOL = 1e-6           # HD95 / ASSD card vs CPU, relative
EVAL_SCIPY_RTOL = 1e-5     # HD95 / ASSD vs the scipy oracle, relative
EVAL_TIMED_RUNS = 20
SUMMARY_KEYS = {"volume", "num_slices", "pred_path", "dice", "iou", "hd95",
                "assd"}
MICROBATCH_REQUESTS = 8    # concurrent /v1/segment requests in phase 7
MICROBATCH_SLICES = 6      # a request's slices, fewer than a batch of 16
MICROBATCH_WINDOW_MS = 5.0
MICROBATCH_BURSTS = 5      # timed bursts per window, window off and on
NEAR_THRESHOLD = 1e-5      # mask pixels this close to 0.5 may differ
UNETPP_BATCH = 4           # logits card vs CPU
COILS = 15                 # fastMRI knee multi-coil: 15 coils at 640x368
MULTICOIL_REQUEST_SLICES = 4
RESTORED_SLICES = 4        # N4 + NL-means card vs CPU on this many slices
RESTORED_TOL = 1e-3        # their z-scored tensors, times 1 + max|t|
KERNEL_SOURCES = ("open_close", "label_prop")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_mask_launches() -> None:
    """Every launch count of the body mask's kernels to 0."""
    morphology.LAUNCHES = 0
    components.reset_launches()


def mask_launches() -> dict:
    """The body mask's kernel launches since the last reset."""
    return {"open_close": morphology.LAUNCHES,
            "label_components": components.LAUNCHES["label_components"]}


def open_close_bound_ms(shape) -> tuple:
    """Least time for disk(2) open+close of a uint8 (S, H, W) stack on an
    H100 and what sets it: read and write each pixel once (bytes), against
    the bit-packed pass's INT32 operations, 8 funnel shifts and 12 AND/OR
    per 32-pixel word and pass, four passes (operations), at the INT32
    rate: 64 INT32 lanes an SM, half its FP32 lanes, with no FMA to count
    twice."""
    s, h, w = shape
    bytes_ms = 2 * s * h * w / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_WORD * s * h * -(-w // 32) / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def conv_open_close(dev: torch.device, dtype: torch.dtype):
    """The JAX package's default formulation of disk(2) open+close
    (``ops/maskops.py``), four ``F.conv2d`` calls with the 13-tap disk: an
    erosion pads with 1 and keeps sums >= 12.5, a dilation pads with 0 and
    keeps sums > 0.5. Sums of at most 13 are exact in fp16 and f32. A
    yardstick for the kernel; the port never calls it."""
    se = torch.from_numpy(morphology.disk(2)).to(dev, dtype)[None, None]

    def erode(m):
        return (F.conv2d(F.pad(m, (2, 2, 2, 2), value=1.0), se)
                >= 12.5).to(dtype)

    def dilate(m):
        return (F.conv2d(m, se, padding=2) > 0.5).to(dtype)

    def fn(x):
        m = x.unsqueeze(1).to(dtype)
        return erode(dilate(dilate(erode(m)))).squeeze(1).to(torch.uint8)
    return fn


def _precision_flags() -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _set_precision_flags(flags: dict) -> None:
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]


def phase_setup() -> tuple:
    """Returns the card's ``nvidia-smi`` line and torch's own precision
    flags, which the serving phase restores before it starts the daemon."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    defaults = _precision_flags()
    # the parity phases 2-4 compare f32 on the card with f32 on the CPU
    parity = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
              "cudnn_deterministic": True}
    _set_precision_flags(parity)
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "torch_defaults": defaults,
          "parity_phases": parity})
    return smi, defaults


def _ptxas(name: str) -> dict:
    report = _build.ptxas_report(name)
    return {"source": f"mri_acl_imagesegmentation_adsp_tpu_torch/csrc/"
                      f"{name}.cu",
            "ptxas": [{"registers": int(r), "spill_stores_bytes": int(st),
                       "spill_loads_bytes": int(ld)}
                      for st, ld, r in zip(
                          re.findall(r"(\d+) bytes spill stores", report),
                          re.findall(r"(\d+) bytes spill loads", report),
                          re.findall(r"Used (\d+) registers", report))],
            "ptxas_lines": [ln.strip() for ln in report.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling" in ln]}


def phase_build() -> None:
    """One nvcc a source, all started together, then each library loaded
    and bound by its wrapper."""
    t0 = time.perf_counter()
    fresh = {n: not _build.library_path(n).exists() for n in KERNEL_SOURCES}
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for built in [pool.submit(_build.build, n) for n in KERNEL_SOURCES]:
            built.result()
    morphology.load_library()
    components.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": fresh, "kernels": [_ptxas(n) for n in KERNEL_SOURCES]})


def edge_cases(rng) -> list:
    """``(name, mask, band_rows)`` for the kernel's word and band edges:
    every width of ``EDGE_W`` at heights 1, 2 and 640 with the wrapper's
    band choice and at R-1, R, R+1, R+9 for each band height R it can
    pick (forced), each a stack of one slice per density of ``DENSITIES``;
    (S, 640, 368) stacks for S = 1, 8, 35; and the three border cases.
    tests/test_torch_cuda.py checks the same list."""
    heights = [(1, None), (2, None), (640, None)] + [
        (r + d, r) for r in morphology.BAND_ROWS for d in (-1, 0, 1, 9)]
    cases = []
    for w in EDGE_W:
        for h, rows in heights:
            m = np.stack([rng.random((h, w)) < d for d in DENSITIES])
            cases.append((f"w{w}_h{h}_r{rows or 'auto'}", m, rows))
    for s in (1, 8, 35):
        m = np.stack([rng.random(VOLUME[1:]) < DENSITIES[i % 3]
                      for i in range(s)])
        cases.append((f"s{s}_640x368", m, None))
    single = np.zeros((2, 33, 47), bool)
    single[:, 16, 20] = True
    cases += [("ones", np.ones((2, 33, 47), bool), None),
              ("ones_volume", np.ones(VOLUME, bool), None),
              ("zeros", np.zeros((2, 33, 47), bool), None),
              ("single_pixel", single, None)]
    return cases


def check_cases(dev: torch.device, cases: list) -> int:
    """Holds the kernel bit-equal to the plain version at every case;
    returns the largest |kernel - plain| it saw (0 when all are equal)."""
    max_err = 0
    for name, m, rows in cases:
        x = torch.from_numpy(m.astype(np.uint8)).to(dev)
        got = morphology._open_close(x, rows)
        torch.cuda.synchronize()
        want = morphology.open_close_reference(x)
        err = (got.int() - want.int()).abs()
        max_err = max(max_err, int(err.max()))
        n_diff = int((err != 0).sum())
        if n_diff:
            raise AssertionError(f"open_close {name}: {n_diff} pixels "
                                 "differ from the plain version")
        if name.startswith("ones") and not bool(got.all()):
            raise AssertionError("open_close of all ones must stay all ones")
        if name in ("zeros", "single_pixel") and bool(got.any()):
            raise AssertionError(f"open_close {name} must come out empty")
    return max_err


def check_misaligned(dev: torch.device) -> None:
    """Tensors that start off a 16-byte boundary take the kernel's
    bit-stream path; they must give the same bits."""
    rng = np.random.default_rng(7)
    m = torch.from_numpy((rng.random((3, 70, 368)) < 0.5).astype(np.uint8))
    flat = torch.zeros(m.numel() + 16, dtype=torch.uint8, device=dev)
    for offset in (1, 3, 8):
        x = flat[offset:offset + m.numel()].view(m.shape)
        x.copy_(m.to(dev))
        got = morphology._open_close(x, 16)
        if not torch.equal(got, morphology.open_close_reference(x)):
            raise AssertionError(f"open_close at offset {offset} differs "
                                 "from the plain version")


def time_shape(dev: torch.device, shape, rng) -> dict:
    """The kernel, its plain version and the convolution yardstick at one
    main-path shape (a random mask of density 0.5), beside the bound. Each
    card time keeps its ``cuda_ms`` sleep and late runs under ``timers``."""
    x = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8)).to(dev)
    want = morphology.open_close_reference(x)
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    # the yardstick gets cuDNN's fastest algorithm, not a deterministic one
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = (
        True, False)
    timers = {}
    try:
        for dtype in (torch.float16, torch.float32):
            fn = conv_open_close(dev, dtype)
            if not torch.equal(fn(x), want):
                raise AssertionError(f"conv yardstick ({dtype}) differs "
                                     "from the plain version")
            timers["conv_" + str(dtype).removeprefix("torch.")] = cuda_ms(
                lambda: fn(x), cold=True)
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    bound_ms, bound_by = open_close_bound_ms(shape)
    kernel = lambda: morphology.open_close(x)  # noqa: E731
    timers["cold"] = cuda_ms(kernel, cold=True)
    timers["warm"] = cuda_ms(kernel, cold=False)
    timers["plain"] = cuda_ms(lambda: morphology.open_close_reference(x),
                              cold=True, iters=20)
    conv = {k: t["ms"] for k, t in timers.items() if k.startswith("conv_")}
    cold_ms = timers["cold"]["ms"]
    out = {"shape": list(shape),
           "band_rows": morphology.band_plan(shape[0], shape[1])[0],
           "cold_ms": cold_ms, "warm_ms": timers["warm"]["ms"],
           "host_us": host_us(kernel), "plain_ms": timers["plain"]["ms"],
           "conv_ms": min(conv.values()),
           "conv_dtype": min(conv, key=conv.get).removeprefix("conv_"),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / cold_ms, "timers": timers}
    if not cold_ms < out["conv_ms"]:
        raise AssertionError(f"open_close at {shape} is not faster than the "
                             f"convolution yardstick: {cold_ms} vs "
                             f"{out['conv_ms']} ms")
    return out


def phase_kernel(dev: torch.device) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = edge_cases(rng)
    max_err = check_cases(dev, cases)
    check_misaligned(dev)
    volume = time_shape(dev, VOLUME, rng)
    served = time_shape(dev, (SERVE_SLICES,) + VOLUME[1:], rng)
    row = {"name": "open_close", "route": "cuda",
           "source": "mri_acl_imagesegmentation_adsp_tpu_torch/csrc/"
                     "open_close.cu",
           "replaces": "mri_acl_imagesegmentation_adsp_tpu/ops/pallas/"
                       "morphology.py:93",
           "launches": None, "max_abs_err": float(max_err),
           "ms": volume["cold_ms"],
           "plain_ms": volume["plain_ms"], "bound_ms": volume["bound_ms"],
           "bound_by": volume["bound_by"], "library_ms": None,
           "shape": volume["shape"], "warm_ms": volume["warm_ms"],
           "host_us": volume["host_us"], "conv_ms": volume["conv_ms"],
           "served_shape": {
               k: served[k] for k in ("shape", "cold_ms", "warm_ms",
                                      "host_us", "plain_ms", "conv_ms",
                                      "bound_ms", "bound_by")}}
    emit({"phase": "kernel", "seconds": time.perf_counter() - t0,
          "cases": len(cases), "bit_equal": True, "max_abs_err": max_err,
          "volume": volume, "served": served})
    return row


def phase_preprocess(dev: torch.device, shape=VOLUME) -> None:
    t0 = time.perf_counter()
    pair = synthetic_kspace_pairs(seed=1, s=shape[0], h=shape[1], w=shape[2])
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0))
    pre = MRIKneePreprocessor(device=dev, **kw)
    reset_mask_launches()
    t1 = time.perf_counter()
    got = pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    if mask_launches() != {"open_close": 1, "label_components": 1}:
        raise AssertionError(f"the preprocess chain launched the mask "
                             f"kernels {mask_launches()} times, not once each")
    t1 = time.perf_counter()
    pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    cpu_s = time.perf_counter() - t1
    emit({"phase": "preprocess", "seconds": time.perf_counter() - t0,
          "shape": list(pair.shape), "card_first_s": first_s,
          "card_warm_s": warm_s, "cpu_s": cpu_s,
          **compare_packs(got, want, shape[0])})


def compare_packs(got: dict, want: dict, slices: int,
                  tol: float = TENSOR_TOL) -> dict:
    """A card pack against the CPU's: body masks differ in at most
    MASK_DIFF_MAX of their pixels, and on the slices whose masks agree the
    z-scored tensors within ``tol * (1 + max|t|)``."""
    g_mask, w_mask = got["mask"].cpu(), want["mask"]
    if g_mask.shape != (slices, 320, 320) or not bool(w_mask.any()):
        raise AssertionError(f"unexpected mask {tuple(g_mask.shape)}")
    n_diff = int((g_mask != w_mask).sum())
    if n_diff > MASK_DIFF_MAX * w_mask.numel():
        raise AssertionError(f"body masks differ in {n_diff} pixels")
    same = (g_mask == w_mask).flatten(1).all(dim=1)
    g_t, w_t = got["tensor"].cpu(), want["tensor"]
    if not bool(torch.isfinite(g_t).all()) or not bool(same.any()):
        raise AssertionError("non-finite tensor or no slice's masks agree")
    err = float((g_t[same] - w_t[same]).abs().max())
    if err > tol * (1.0 + float(w_t[same].abs().max())):
        raise AssertionError(f"preprocessed tensor differs by {err}")
    return {"mask_bit_equal": n_diff == 0, "mask_diff_pixels": n_diff,
            "mask_pixels": int(w_mask.numel()),
            "slices_with_equal_masks": int(same.sum()),
            "tensor_max_abs_err": err, "tensor_tol": tol}


def phase_model(dev: torch.device) -> torch.nn.Module:
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1234)
    model = init_weights(build_unet("unet", "resnet34", in_ch=1, classes=1),
                         gen).eval()
    x = torch.randn(MODEL_BATCH, generator=gen)
    with torch.inference_mode():
        t1 = time.perf_counter()
        want = model(x)
        cpu_s = time.perf_counter() - t1
        card = copy.deepcopy(model).to(dev)
        xd = x.to(dev)
        got = card(xd).cpu()
        ms = cuda_ms(lambda: card(xd), cold=False, iters=10)["ms"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"card logits differ from CPU by {err} "
                             f"(max |logit| {scale})")
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "model": "unet/resnet34", "batch": list(MODEL_BATCH),
          "logits_max_abs_err": err, "logits_max_abs": scale,
          "tol": f"{LOGIT_RTOL} * max|logit|", "card_ms_per_batch": ms,
          "cpu_s_per_batch": cpu_s})
    return model


def _npz_bytes(compress: bool = False, **arrays) -> bytes:
    buf = io.BytesIO()
    (np.savez_compressed if compress else np.savez)(buf, **arrays)
    return buf.getvalue()


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=120) as r:
        reply = r.read()
    with np.load(io.BytesIO(reply)) as z:
        return {k: z[k] for k in z.files}


def _serve_breakdown(runner, body: bytes) -> dict:
    """Seconds of each stage of one /v1/segment_kspace request, run
    in-process with a synchronize after each device stage."""
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    kpair, t_dec = timed(lambda: np.load(io.BytesIO(body))["kspace"])
    pre = runner._pres[(0.0, 1.0)]
    packed, t_pre = timed(lambda: pre.preprocess_volume_pairs(kpair))
    probs, t_model = timed(lambda: segment_volume_2d(
        runner.apply_fn, packed["tensor"], k=runner.k,
        batch_size=runner.batch_size, classes=runner.classes))
    out, t_d2h = timed(lambda: {
        "mask": threshold_probs(probs, runner.classes, 0.5).cpu().numpy(),
        "body_mask": packed["mask"].cpu().numpy()})
    _, t_enc = timed(lambda: _npz_bytes(True, **out))
    return {"decode_request": t_dec, "preprocess": t_pre, "model": t_model,
            "masks_to_host": t_d2h, "encode_response": t_enc}


def _start_server(ckpt: str, dev: torch.device, batch_size: int = 16,
                  **extra):
    server = serve.create_server(SimpleNamespace(
        ckpt=ckpt, host="127.0.0.1", port=0, batch_size=batch_size,
        pre_out_size="320,320", device=str(dev), **extra))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, "http://127.0.0.1:%d" % server.server_address[1]


def _stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.runner.close()
    thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread still running after shutdown")


def phase_serve(model: torch.nn.Module, dev: torch.device, defaults: dict,
                shape=(SERVE_SLICES,) + VOLUME[1:]) -> dict:
    """The main path: returns the mask kernels' launches during the
    requests.
    It starts from torch's own precision flags, so the daemon runs with
    the settings that its command line gives it."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    vols = [synthetic_kspace_pairs(seed=100 + i, s=shape[0], h=shape[1],
                                   w=shape[2]) for i in range(3)]
    bodies = [_npz_bytes(kspace=v) for v in vols]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.ckpt")
        save_best(ckpt, model.state_dict(),
                  {"model": "unet", "encoder": "resnet34", "k": 1,
                   "classes": 1, "imagenet_norm": False})
        server, thread, url = _start_server(
            ckpt, dev, warmup_shape=f"{shape[0]},320,320")
        served_flags = _precision_flags()
        try:
            if served_flags["cudnn_allow_tf32"] or served_flags[
                    "matmul_allow_tf32"]:
                raise AssertionError(f"the daemon serves with TF32 on: "
                                     f"{served_flags}")
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            if health.get("status") != "ok":
                raise AssertionError(f"healthz: {health}")
            runner = server.RequestHandlerClass.runner
            expected = [runner.segment_kspace(v, 0.5, False) for v in vols]
            latencies, in_lock = [], []
            reset_mask_launches()
            for i, (body, exp) in enumerate(zip(bodies, expected)):
                before = mask_launches()
                t1 = time.perf_counter()
                out = _post(url + "/v1/segment_kspace", body)
                latencies.append(time.perf_counter() - t1)
                in_lock.append(runner.last_latency_s)
                if any(n != before[k] + 1
                       for k, n in mask_launches().items()):
                    raise AssertionError(
                        f"request {i} launched the mask kernels "
                        f"{mask_launches()} times since {before}, not once")
                for key in ("mask", "body_mask"):
                    if (out[key].shape != (shape[0], 320, 320)
                            or out[key].dtype != np.uint8):
                        raise AssertionError(
                            f"request {i}: {key} {out[key].shape} "
                            f"{out[key].dtype}")
                    if not np.array_equal(out[key], exp[key]):
                        raise AssertionError(f"request {i}: served {key} "
                                             "differs from in-process")
                if list(out["indices"]) != list(range(shape[0])):
                    raise AssertionError(f"request {i}: {out['indices']}")
            launches = mask_launches()
            breakdown = _serve_breakdown(runner, bodies[0])
        finally:
            _stop_server(server, thread)
    emit({"phase": "serve", "seconds": time.perf_counter() - t0,
          "endpoint": "/v1/segment_kspace", "requests": len(vols),
          "request_shape": list(vols[0].shape),
          "request_mb": len(bodies[0]) / 1e6, "latency_s": latencies,
          "runner_locked_s": in_lock, "breakdown_s": breakdown,
          "precision_flags": served_flags, "launches": launches})
    return launches

def _train_model(seed: int, name: str = "unet") -> torch.nn.Module:
    """The reference's model (or UNet++) at full width with seeded random
    weights."""
    return init_weights(build_unet(name, "resnet34", in_ch=1, classes=1),
                        torch.Generator().manual_seed(seed))


def _engine(model: torch.nn.Module, aug: str, amp: bool) -> Engine:
    """The reference run's loss and optimizer (lr 1e-3, wd 1e-4, clip 5)."""
    return Engine(model, LossManager(classes=1, name="dice_bce"),
                  make_optimizer(model.parameters(), 1e-3, 1e-4, 5.0),
                  classes=1, aug=aug, amp=amp)


def pack_volumes(dev: torch.device, art: str) -> dict:
    """The training path's kernels: one open/close and one
    label_components launch per packed volume, counted from 0 just before
    the packing."""
    pre = MRIKneePreprocessor(out_size=(320, 320), slice_keep=(0.3, 0.7),
                              device=dev)
    pairs = [synthetic_kspace_pairs(seed=i, s=VOLUME[0], h=VOLUME[1],
                                    w=VOLUME[2])
             for i in range(TRAIN_VOLUMES)]
    secs, slices = [], []
    reset_mask_launches()
    for i, pair in enumerate(pairs):
        t1 = time.perf_counter()
        info = pack_kspace_volume(pre, pair, os.path.join(art, f"vol{i}"))
        secs.append(time.perf_counter() - t1)
        slices.append(info["num_slices"])
    launches = mask_launches()
    if set(launches.values()) != {TRAIN_VOLUMES}:
        raise AssertionError(f"packing {TRAIN_VOLUMES} volumes launched "
                             f"the mask kernels {launches} times")
    if slices != [14] * TRAIN_VOLUMES:
        raise AssertionError(f"slices per pack {slices}, expected 14 each")
    return {"launches": launches, "pack_s": secs,
            "slices_per_volume": slices}


def train_through_launcher(dev: torch.device, tmp: str) -> dict:
    """Two epochs at the reference settings through the launcher, then the
    best checkpoint served back on the val volume."""
    run = os.path.join(tmp, "run")
    t1 = time.perf_counter()
    rc = launcher.main([
        "--skip-preprocess", "--artifact-dir", os.path.join(tmp, "art"),
        "--list-dir", os.path.join(tmp, "lists"), "--out-dir", run,
        "--epochs", "2", "--batch-size", "8", "--aug", "light",
        "--store-dtype", "bfloat16", "--device", str(dev)])
    secs = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"launcher returned {rc}")
    missing = [f for f in RUN_FILES if not os.path.isfile(
        os.path.join(run, f))]
    samples = sorted(f for f in os.listdir(os.path.join(run, "samples"))
                     if f.endswith(".png"))
    if missing or not samples:
        raise AssertionError(f"run dir lacks {missing or 'samples/*.png'}")
    with open(os.path.join(run, "history_step.csv"), encoding="utf-8") as f:
        losses = [float(r["train_loss_step"]) for r in csv.DictReader(f)]
    if len(losses) != 10 or not all(np.isfinite(losses)):
        raise AssertionError(f"step losses {losses}: expected 10 finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the train loss did not fall: {losses}")
    with open(os.path.join(run, "history.json"), encoding="utf-8") as f:
        history = json.load(f)
    model, _ = load_model_from_ckpt(os.path.join(run, "best.ckpt"), dev)
    with open(os.path.join(tmp, "lists", "val.txt"), encoding="utf-8") as f:
        val_npz = f.read().split()
    with np.load(val_npz[0]) as z:
        img, msk = z["img"], z["msk"]
    probs = segment_volume_2d(model, torch.from_numpy(img).to(dev),
                              batch_size=16)
    if (tuple(probs.shape) != img.shape
            or not bool(torch.isfinite(probs).all())):
        raise AssertionError(f"served probabilities {tuple(probs.shape)}")
    pred = threshold_probs(probs, 1, 0.5).cpu().numpy().astype(bool)
    inter = float((pred & (msk > 0)).sum())
    served_dice = (2 * inter + 1e-7) / (pred.sum() + (msk > 0).sum() + 1e-7)
    return {"seconds": secs, "step_losses": losses, "history": history,
            "samples": len(samples), "served_val_slices": int(img.shape[0]),
            "served_val_dice_f32": float(served_dice)}


def _one_step(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
              d: torch.device) -> dict:
    """One engine step (aug none, f32) of ``model`` on device ``d``: its
    loss, gradients, BN running stats and updated parameters, on the CPU."""
    model = copy.deepcopy(model).to(d)
    eng = _engine(model, "none", amp=False)
    loss, grads = eng.grads_one(x.to(d), y.to(d), None)
    eng.optimizer.step(grads)
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss),
            "grads": {n: g.cpu() for n, g in zip(names, grads)},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()}}


def _rel_to_max(got: dict, want: dict) -> dict:
    """Per tensor: max |got - want| / max |want|."""
    return {n: float((got[n] - w).abs().max()) / (float(w.abs().max())
                                                  + 1e-30)
            for n, w in want.items()}


def step_parity(dev: torch.device, src: SliceStore) -> dict:
    """One engine step from the same weights and batch on the card and on
    the CPU (f32, TF32 off, cuDNN deterministic: the caller's flags).

    The loss and the BN running stats are held to STEP_LOSS_RTOL and
    STEP_BN_RTOL. A gradient tensor is held to STEP_GRAD_RTOL of its max
    |g|, or, where f32 cannot resolve that here, to STEP_GRAD_FLOOR_X
    times the floor: how far the CPU's gradients move, at worst over the
    tensors, when every input pixel moves by one f32 ulp. At the
    reference's full width from a random init the deep layers' gradients
    are sensitive enough that this floor is a few percent of a tensor's
    max. So the same step is also taken in float64 on both sides
    (``tools/probe_train_step.py:grads_f64``), where rounding cannot show,
    and its gradients are held to STEP_GRAD_F64_RTOL."""
    x = torch.from_numpy(src.images[:2, None].copy())
    y = torch.from_numpy(src.masks[:2].astype(np.uint8))
    model = _train_model(7)
    cpu_dev = torch.device("cpu")
    cpu = _one_step(model, x, y, cpu_dev)
    ulp = torch.nextafter(x, torch.where(
        torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
        < 0.5, torch.inf, -torch.inf))
    moved = _one_step(model, ulp, y, cpu_dev)
    card = _one_step(model, x, y, dev)
    loss64_cpu, g64_cpu = grads_f64(model, x, y, cpu_dev)
    loss64_card, g64_card = grads_f64(model, x, y, dev)
    names = list(cpu["grads"])
    f64_rel = _rel_to_max(dict(zip(names, g64_card)),
                          dict(zip(names, g64_cpu)))
    grad_rel = _rel_to_max(card["grads"], cpu["grads"])
    floor_rel = _rel_to_max(moved["grads"], cpu["grads"])
    floor = max(floor_rel.values())
    grad_tol = max(STEP_GRAD_RTOL, STEP_GRAD_FLOOR_X * floor)
    bn_rel = _rel_to_max(card["stats"], cpu["stats"])
    dp = torch.cat([(card["params"][n] - p).abs().flatten()
                    for n, p in cpu["params"].items()])
    worst = max(grad_rel, key=grad_rel.get)
    out = {"batch": [2, 1, 320, 320], "loss_cpu": cpu["loss"],
           "loss_card": card["loss"],
           "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(
               cpu["loss"]),
           "loss_tol": STEP_LOSS_RTOL,
           "grad_worst_rel_to_max": grad_rel[worst],
           "grad_worst_tensor": worst,
           "grad_median_rel_to_max": float(np.median(list(
               grad_rel.values()))),
           "grad_tensors": len(grad_rel),
           "grad_tensors_within_1e-3": sum(v <= STEP_GRAD_RTOL
                                           for v in grad_rel.values()),
           "grad_floor_one_ulp": floor,
           "loss_rel_one_ulp": abs(moved["loss"] - cpu["loss"]) / abs(
               cpu["loss"]),
           "grad_floor_median": float(np.median(list(floor_rel.values()))),
           "grad_tol": grad_tol,
           "f64_loss_rel_err": abs(loss64_card - loss64_cpu) / abs(
               loss64_cpu),
           "f64_grad_worst_rel_to_max": max(f64_rel.values()),
           "f64_grad_worst_tensor": max(f64_rel, key=f64_rel.get),
           "f64_grad_tol": STEP_GRAD_F64_RTOL,
           "bn_worst_rel_to_max": max(bn_rel.values()),
           "bn_worst_buffer": max(bn_rel, key=bn_rel.get),
           "bn_tol": STEP_BN_RTOL,
           "param_max_abs_diff": float(dp.max()),
           "param_share_over_1e-5": float((dp > 1e-5).float().mean())}
    if (out["loss_rel_err"] > STEP_LOSS_RTOL or grad_rel[worst] > grad_tol
            or out["f64_grad_worst_rel_to_max"] > STEP_GRAD_F64_RTOL
            or out["bn_worst_rel_to_max"] > STEP_BN_RTOL):
        raise AssertionError(f"train step card vs CPU: {out}")
    if out["param_max_abs_diff"] > 2.1e-3:  # Adam moves a step by <= lr
        raise AssertionError(f"parameters moved apart: {out}")
    return out


def train_throughput(dev: torch.device, src: SliceStore, batch: int,
                     amp: bool, model: str = "unet") -> dict:
    """Slices/s of the reference step (aug light) over TIMED_STEPS steps
    after WARMUP_STEPS, the host's per-step work in the window."""
    store = src.to_device(1, torch.bfloat16 if amp else torch.float32, dev)
    eng = _engine(_train_model(0, model).to(dev), "light", amp)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows(steps):
        return torch.randint(0, store.num_slices, (steps, batch),
                             generator=gen, device=dev)
    eng.train_steps(store, rows(WARMUP_STEPS), gen)
    perm = rows(TIMED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    losses = eng.train_steps(store, perm, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite loss at batch {batch}")
    return {"batch": batch, "amp_bf16": amp,
            "store_dtype": str(store.images.dtype).removeprefix("torch."),
            "slices_per_s": TIMED_STEPS * batch / secs,
            "ms_per_step": secs / TIMED_STEPS * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def train_breakdown(dev: torch.device, src: SliceStore, batch: int,
                    amp: bool, steps: int = 10) -> dict:
    """Where a step's time goes: for each stage, the card's time between
    CUDA events recorded around it and the host's time to issue it, over
    ``steps`` steps after two warm-up steps; then one validation pass over
    ``src`` and the best-checkpoint and sample writes, on the host clock
    with a synchronize."""
    store = src.to_device(1, torch.bfloat16 if amp else torch.float32, dev)
    eng = _engine(_train_model(0).to(dev), "light", amp)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randint(0, store.num_slices, (steps + 2, batch),
                         generator=gen, device=dev)
    eng.train_steps(store, rows[:2], gen)
    stages = ("gather", "augment", "forward_loss", "backward", "optimizer")
    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(stages) + 1)] for _ in range(steps)]
    host = dict.fromkeys(stages, 0.0)
    torch.cuda.synchronize()
    for i in range(steps):
        ev = events[i]
        ev[0].record()
        marks = [time.perf_counter()]
        x, y = gather_batch(store, rows[2 + i])
        ev[1].record()
        marks.append(time.perf_counter())
        x, y = augment_batch(x, y, gen, "light")
        ev[2].record()
        marks.append(time.perf_counter())
        eng.model.train()
        loss = eng._loss_from_logits(eng._forward(x), y)
        ev[3].record()
        marks.append(time.perf_counter())
        grads = torch.autograd.grad(loss, eng.params)
        ev[4].record()
        marks.append(time.perf_counter())
        eng.optimizer.step(list(grads))
        ev[5].record()
        marks.append(time.perf_counter())
        for j, st in enumerate(stages):
            host[st] += marks[j + 1] - marks[j]
    torch.cuda.synchronize()
    card = {st: sum(events[i][j].elapsed_time(events[i][j + 1])
                    for i in range(steps)) / steps
            for j, st in enumerate(stages)}
    t1 = time.perf_counter()
    eng.validate(store, max(1, batch // 2))
    validate_s = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        save_best(os.path.join(tmp, "best.ckpt"), eng.model.state_dict(),
                  {"model": "unet"})
        ckpt_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        eng.save_samples(store, tmp, max_samples=6)
        samples_s = time.perf_counter() - t1
    return {"batch": batch, "amp_bf16": amp, "steps": steps,
            "card_ms": card, "card_ms_step": sum(card.values()),
            "host_ms": {st: v / steps * 1e3 for st, v in host.items()},
            "host_ms_step": sum(host.values()) / steps * 1e3,
            "validate_s": validate_s, "validate_slices": store.num_slices,
            "save_best_s": ckpt_s, "save_samples_s": samples_s}


def phase_train(dev: torch.device, defaults: dict, tmp: str) -> dict:
    """The training path: returns the mask kernels' launches while packing.
    The packs, lists and run directory stay in ``tmp`` for phase 7."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    packed = pack_volumes(dev, os.path.join(tmp, "art"))
    trained = train_through_launcher(dev, tmp)
    with open(os.path.join(tmp, "lists", "train.txt"),
              encoding="utf-8") as f:
        src = SliceStore.from_files(f.read().split())
    timed_flags = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
                   "cudnn_deterministic": False}
    _set_precision_flags(timed_flags)
    speed, stages = {}, {}
    for name, batch, amp in THROUGHPUT:
        speed[name] = train_throughput(dev, src, batch, amp)
        torch.cuda.empty_cache()
        stages[name] = train_breakdown(dev, src, batch, amp)
        torch.cuda.empty_cache()
    emit({"phase": "train_speed", "throughput": speed,
          "throughput_flags": timed_flags,
          "throughput_steps": {"warmup": WARMUP_STEPS,
                               "timed": TIMED_STEPS},
          "breakdown": stages})
    parity_flags = dict(timed_flags, cudnn_deterministic=True)
    _set_precision_flags(parity_flags)
    parity = step_parity(dev, src)
    _set_precision_flags(defaults)
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          "model": "unet/resnet34", "input": [1, 320, 320],
          "pack": packed, "launcher": trained,
          "train_slices": int(len(src)), "launcher_flags": defaults,
          "step_parity": parity, "step_parity_flags": parity_flags,
          "slices_per_s": {k: v["slices_per_s"] for k, v in speed.items()},
          "pack_s_per_volume": sum(packed["pack_s"]) / len(packed["pack_s"])})
    return packed["launches"]


def infer_cli(dev: torch.device, tmp: str) -> dict:
    """The batch inference CLI on phase 6's val list and best checkpoint,
    with --metrics, plain and with --tta hflip: every summary value finite,
    and seconds per volume."""
    lst = os.path.join(tmp, "lists", "val.txt")
    with open(lst, encoding="utf-8") as f:
        n_vol = len(f.read().split())
    out = {}
    for name, extra in (("plain", []), ("tta_hflip", ["--tta", "hflip"])):
        out_dir = os.path.join(tmp, "preds_" + name)
        flags = _precision_flags()
        t1 = time.perf_counter()
        rc = infer.main(["--ckpt", os.path.join(tmp, "run", "best.ckpt"),
                         "--list", lst, "--out-dir", out_dir, "--metrics",
                         "--device", str(dev), *extra])
        secs = time.perf_counter() - t1
        if _precision_flags() != flags:
            raise AssertionError(f"infer {name} left the precision flags "
                                 f"changed: {_precision_flags()}")
        with open(os.path.join(out_dir, "summary.json"),
                  encoding="utf-8") as f:
            summary = json.load(f)
        if rc != 0 or len(summary) != n_vol:
            raise AssertionError(f"infer {name}: rc {rc}, {summary}")
        for entry in summary:
            pred = np.load(entry["pred_path"])
            if (set(entry) != SUMMARY_KEYS or pred.dtype != np.uint8
                    or pred.shape[0] != entry["num_slices"]
                    or not all(np.isfinite(entry[k]) for k in
                               ("dice", "iou", "hd95", "assd"))):
                raise AssertionError(f"infer {name}: {entry}")
        out[name] = {"s_per_volume": secs / n_vol, "volumes": n_vol,
                     "summary": [{k: v for k, v in e.items()
                                  if k not in ("volume", "pred_path")}
                                 for e in summary]}
    return out


def scipy_hd95_assd(pred: np.ndarray, gt: np.ndarray) -> tuple:
    """The reference's medimetrics HD95 and ASSD of one slice, by scipy:
    the border is ``a ^ (edt(~a) > 0 & a)`` (the whole mask), distances
    from each mask's pixels to the other's nearest, both ways."""
    from scipy.ndimage import distance_transform_edt as np_edt
    a, b = pred.astype(bool), gt.astype(bool)
    a_border = a ^ np.logical_and(np_edt(~a) > 0, a)
    b_border = b ^ np.logical_and(np_edt(~b) > 0, b)
    a_border = a_border if a_border.any() else a
    b_border = b_border if b_border.any() else b
    d = np.concatenate([np_edt(~b)[a_border], np_edt(~a)[b_border]])
    if d.size == 0:
        return 0.0, 0.0
    return float(np.percentile(d, 95)), float(d.mean())


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(np.abs(want), 1e-30)))


def evaluate_card_vs_cpu(dev: torch.device, tmp: str) -> dict:
    """evaluate_volume at EVAL_SLICES x 320 x 320: gt is the val pack's body
    mask tiled to EVAL_SLICES slices, pred the same shifted EVAL_SHIFT_PX
    along W and opened with disk(2) by the port's plain morphology."""
    with open(os.path.join(tmp, "lists", "val.txt"), encoding="utf-8") as f:
        with np.load(f.read().split()[0]) as z:
            msk = z["msk"].astype(np.uint8)
    reps = -(-EVAL_SLICES // msk.shape[0])
    gt = np.concatenate([msk] * reps)[:EVAL_SLICES]
    shifted = np.zeros_like(gt)
    shifted[..., EVAL_SHIFT_PX:] = gt[..., :-EVAL_SHIFT_PX]
    pred = morphology.binary_opening(torch.from_numpy(shifted),
                                     morphology.disk(2)).to(torch.uint8)
    gt_t = torch.from_numpy(gt)
    pred_d, gt_d = pred.to(dev), gt_t.to(dev)
    n = EVAL_CPU_SLICES

    # the exact EDT of the largest mask's background, and the no-zero
    # sentinel: an empty prediction is H + W from every gt pixel
    k = int(gt.sum(axis=(1, 2)).argmax())
    edt_cpu = edt.edt(gt_t[k] == 0)
    edt_card = edt.edt(gt_d[k] == 0).cpu()
    ones = torch.ones(1, 320, 320, dtype=torch.uint8)
    sentinel = edt.edt(ones.to(dev)).cpu()
    empty_hd = edt.hd95_assd(torch.zeros_like(gt_d[k:k + 1]), gt_d[k:k + 1])
    empty_hd_cpu = edt.hd95_assd(torch.zeros_like(gt_t[k:k + 1]),
                                 gt_t[k:k + 1])
    if not torch.equal(edt_card, edt_cpu):
        raise AssertionError("the EDT differs card vs CPU: max "
                             f"{float((edt_card - edt_cpu).abs().max())}")
    if not (torch.equal(sentinel, torch.full_like(sentinel, 640.0))
            and float(empty_hd[0]) == float(empty_hd_cpu[0]) == 640.0):
        raise AssertionError("the no-zero sentinel is not H + W = 640")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    first = evaluate_volume(pred_d, gt_d)
    first_s = time.perf_counter() - t1
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    t1 = time.perf_counter()
    evaluate_volume(pred_d, gt_d)
    warm_s = time.perf_counter() - t1
    per_card = slice_metrics(pred_d, gt_d).cpu().numpy()
    per_cpu = slice_metrics(pred[:n], gt_t[:n]).numpy()
    oracle = np.array([scipy_hd95_assd(pred[i].numpy(), gt[i])
                       for i in range(n)])
    errs = {"dice_iou_vs_cpu": _rel_err(per_card[:n, :2], per_cpu[:, :2]),
            "hd95_assd_vs_cpu": _rel_err(per_card[:n, 2:], per_cpu[:, 2:]),
            "hd95_assd_vs_scipy": _rel_err(per_card[:n, 2:], oracle)}
    if (errs["dice_iou_vs_cpu"] > EVAL_RTOL
            or errs["hd95_assd_vs_cpu"] > EVAL_RTOL
            or errs["hd95_assd_vs_scipy"] > EVAL_SCIPY_RTOL):
        raise AssertionError(f"evaluate_volume card vs CPU / scipy: {errs}")
    if not all(np.isfinite(list(first.values()))) or first["assd"] <= 0:
        raise AssertionError(f"evaluate_volume: {first}")
    timers = {"cold": cuda_ms(lambda: slice_metrics(pred_d, gt_d), cold=True,
                              iters=EVAL_TIMED_RUNS),
              "warm": cuda_ms(lambda: slice_metrics(pred_d, gt_d),
                              cold=False, iters=EVAL_TIMED_RUNS)}
    # one 8-slice chunk's parts: an exact EDT, the sort of its distances,
    # and the chunk's HD95 and ASSD with both transforms
    c = SURFACE_CHUNK
    dist = torch.where(pred_d[:c].flatten(1) > 0,
                       edt.edt(gt_d[:c] == 0).flatten(1), torch.inf)
    dist = torch.cat([dist, dist], dim=1)
    parts = {"edt": cuda_ms(lambda: edt.edt(gt_d[:c] == 0), cold=False,
                            iters=EVAL_TIMED_RUNS),
             "sort": cuda_ms(lambda: torch.sort(dist, dim=-1), cold=False,
                             iters=EVAL_TIMED_RUNS),
             "hd95_assd": cuda_ms(lambda: edt.hd95_assd(pred_d[:c], gt_d[:c]),
                                  cold=False, iters=EVAL_TIMED_RUNS)}
    if any(t["late_runs"] for t in (*timers.values(), *parts.values())):
        raise AssertionError(f"evaluate_volume timing held host time: "
                             f"{timers}, {parts}")
    return {"shape": list(gt.shape), "metrics": first,
            "cpu_checked_slices": n, "errors": errs,
            "tolerances": {"vs_cpu": EVAL_RTOL, "vs_scipy": EVAL_SCIPY_RTOL},
            "edt_bit_equal": True, "sentinel": 640.0,
            "card_ms_per_volume": {k: t["ms"] for k, t in timers.items()},
            "card_ms_per_8_slice_chunk": {k: t["ms"] for k, t in
                                          parts.items()},
            "timers": timers, "host_s_first_call": first_s,
            "host_s_warm_call": warm_s, "peak_gib": peak_gib}


def _check_masks(got: np.ndarray, probs: torch.Tensor, what: str) -> dict:
    """Served masks against in-process probabilities: equal except where
    the probability lies within NEAR_THRESHOLD of 0.5. Returns the count of
    pixels that near and of all pixels that differ."""
    p = probs[:, 0].cpu().numpy()
    near = np.abs(p - 0.5) < NEAR_THRESHOLD
    want = (p > 0.5).astype(np.uint8)
    if got.shape != p.shape or not np.array_equal(got[~near], want[~near]):
        raise AssertionError(f"{what}: served masks differ from in-process")
    return {"near": int(near.sum()), "differ": int((got != want).sum())}


def _metricsz(url: str) -> dict:
    with urllib.request.urlopen(url + "/metricsz", timeout=30) as r:
        text = r.read().decode()
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if not ln.startswith("#")}


def _burst(url: str, vols: list) -> tuple:
    """One concurrent /v1/segment request per volume: ``(wall seconds of
    the burst, each request's seconds, the replies)``."""
    replies, latency, errors = [None] * len(vols), [0.0] * len(vols), []
    bodies = [_npz_bytes(img=v) for v in vols]

    def client(i):
        t = time.perf_counter()
        try:
            replies[i] = _post(url + "/v1/segment", bodies[i])
        except Exception as exc:            # noqa: BLE001
            errors.append(f"{i}: {exc!r}")
        latency[i] = time.perf_counter() - t
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(vols))]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    burst_s = time.perf_counter() - t1
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    return burst_s, latency, replies


def serve_tta_microbatched(model: torch.nn.Module, dev: torch.device,
                           tmp: str) -> dict:
    """Phase 4's model behind a daemon with --tta hflip, its default batch
    of 16 and a 5 ms micro-batching window: MICROBATCH_REQUESTS concurrent
    /v1/segment requests of MICROBATCH_SLICES packed slices each, so that
    a group's batches mix slices of several requests, then one
    /v1/segment_kspace and the /metricsz counts. Then the same daemon
    without the window beside it, and bursts timed on each in turn.

    On the card a slice's f32 logits move with the size of the batch it
    runs in (cuDNN picks its algorithm by shape), so the grouped masks are
    held to in-process ``segment_volumes_2d`` over the groups that the
    dispatcher formed, recorded as it runs; how far they lie from the
    per-request masks is reported."""
    ckpt = os.path.join(tmp, "phase4.ckpt")
    save_best(ckpt, model.state_dict(),
              {"model": "unet", "encoder": "resnet34", "k": 1, "classes": 1,
               "imagenet_norm": False})
    vols = []
    for i in range(TRAIN_VOLUMES):
        with np.load(os.path.join(tmp, "art", f"vol{i}", "volume.npz")) as z:
            img = z["img"][:, 0]
        vols += [img[:MICROBATCH_SLICES], img[-MICROBATCH_SLICES:]]
    vols = vols[:MICROBATCH_REQUESTS]
    kpair = synthetic_kspace_pairs(seed=300, s=SERVE_SLICES, h=VOLUME[1],
                                   w=VOLUME[2])
    warm = f"{MICROBATCH_SLICES},320,320"
    server, thread, url = _start_server(
        ckpt, dev, warmup_shape=warm, tta="hflip",
        microbatch_window_ms=MICROBATCH_WINDOW_MS)
    runner = server.RequestHandlerClass.runner
    groups = []
    served_many = runner.segment_many

    def recording(group, thr=None):
        groups.append([np.array(v) for v in group])
        return served_many(group, thr)
    try:
        runner.segment_many = recording
        try:
            burst_s, _, replies = _burst(url, vols)
        finally:
            del runner.segment_many
        local, _ = load_model_from_ckpt(ckpt, dev)
        grouped = [None] * len(vols)
        for group in groups:
            outs = segment_volumes_2d(
                local, [torch.from_numpy(v).to(dev) for v in group],
                tta="hflip")
            for v, p in zip(group, outs):
                i = next(j for j, w in enumerate(vols)
                         if np.array_equal(v, w))
                if grouped[i] is not None:
                    raise AssertionError(f"request {i} ran in two groups")
                grouped[i] = p
        if any(p is None for p in grouped):
            raise AssertionError("a request ran in no group")
        near = [_check_masks(r["mask"], p, f"micro-batched request {i}")
                for i, (r, p) in enumerate(zip(replies, grouped))]
        # per volume, as a request without micro-batching runs it
        probs = [segment_volume_2d(local, torch.from_numpy(v).to(dev),
                                   tta="hflip") for v in vols]
        vs_request = _mask_margin(replies, probs)
        before = mask_launches()
        kreply = _post(url + "/v1/segment_kspace", _npz_bytes(kspace=kpair))
        kspace_launches = {k: n - before[k]
                           for k, n in mask_launches().items()}
        if (set(kspace_launches.values()) != {1}
                or kreply["mask"].shape != (SERVE_SLICES, 320, 320)):
            raise AssertionError(f"/v1/segment_kspace launched the mask "
                                 f"kernels {kspace_launches} times")
        metrics = _metricsz(url)
        if (metrics["serve_requests_total"] != len(vols) + 1
                or metrics["serve_errors_total"] != 0):
            raise AssertionError(f"/metricsz: {metrics}")
        timing = time_microbatching(ckpt, dev, url, vols, probs)
    finally:
        _stop_server(server, thread)
    return {"requests": len(vols), "slices_per_request": [
                int(v.shape[0]) for v in vols], "batch_size": 16,
            "group_sizes": [len(g) for g in groups],
            "first_burst_s": burst_s,
            "mask_pixels": int(sum(v.size for v in vols)),
            "near_threshold_and_differing_pixels": near,
            "vs_per_request": vs_request,
            "kspace_launches": kspace_launches, "metricsz": metrics,
            "timed": timing}


def _mask_margin(replies: list, probs: list) -> dict:
    """Served masks against per-request probabilities: the pixels that
    differ, and the largest distance from 0.5 of the probability at one."""
    differ, margin = 0, 0.0
    for r, p in zip(replies, probs):
        p = p[:, 0].cpu().numpy()
        bad = r["mask"] != (p > 0.5)
        differ += int(bad.sum())
        if bad.any():
            margin = max(margin, float(np.abs(p - 0.5)[bad].max()))
    return {"differ": differ, "max_abs_p_minus_half": margin}


def time_microbatching(ckpt: str, dev: torch.device, url_on: str,
                       vols: list, probs: list) -> dict:
    """The burst on a daemon without the window (each request its own
    batch, queued on the device lock) and on the one with it, in turn,
    MICROBATCH_BURSTS times each after one untimed burst on the new
    daemon, whose masks are checked too."""
    server, thread, url_off = _start_server(
        ckpt, dev, warmup_shape=f"{MICROBATCH_SLICES},320,320", tta="hflip")
    out = {"window_ms": {"off": 0.0, "on": MICROBATCH_WINDOW_MS},
           "burst_s": {"off": [], "on": []},
           "mean_request_s": {"off": [], "on": []},
           "max_request_s": {"off": [], "on": []}}
    try:
        _, _, replies = _burst(url_off, vols)
        out["unbatched_near_threshold_and_differing_pixels"] = [
            _check_masks(r["mask"], p, f"request {i} without the window")
            for i, (r, p) in enumerate(zip(replies, probs))]
        for _ in range(MICROBATCH_BURSTS):
            for key, url in (("off", url_off), ("on", url_on)):
                burst_s, lat, _ = _burst(url, vols)
                out["burst_s"][key].append(burst_s)
                out["mean_request_s"][key].append(float(np.mean(lat)))
                out["max_request_s"][key].append(max(lat))
    finally:
        # the daemons put the precision flags back in the reverse order of
        # their start
        _stop_server(server, thread)
    out["median_burst_s"] = {k: float(np.median(v))
                             for k, v in out["burst_s"].items()}
    return out


def unetpp_full_width(dev: torch.device, src: SliceStore, tmp: str) -> dict:
    """UNet++ (resnet34, decoder 256-128-64-32-16, 320^2, one class): eval
    logits card vs CPU (TF32 off), b8 bf16 train slices/s, and one
    checkpoint served back over /v1/segment."""
    model = _train_model(11, "unetpp").eval()
    x = torch.randn((UNETPP_BATCH, 1, 320, 320),
                    generator=torch.Generator().manual_seed(5))
    flags = _precision_flags()
    _set_precision_flags({"cudnn_allow_tf32": False,
                          "matmul_allow_tf32": False,
                          "cudnn_deterministic": True})
    try:
        with torch.inference_mode():
            want = model(x)
            card = copy.deepcopy(model).to(dev)
            got = card(x.to(dev)).cpu()
    finally:
        _set_precision_flags(flags)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"UNet++ card logits differ from CPU by {err} "
                             f"(max |logit| {scale})")
    del card
    torch.cuda.empty_cache()
    _set_precision_flags({"cudnn_allow_tf32": False,
                          "matmul_allow_tf32": False,
                          "cudnn_deterministic": False})
    try:
        speed = train_throughput(dev, src, 8, True, model="unetpp")
    finally:
        _set_precision_flags(flags)
    torch.cuda.empty_cache()
    ckpt = os.path.join(tmp, "unetpp.ckpt")
    save_best(ckpt, model.state_dict(),
              {"model": "unetpp", "encoder": "resnet34", "k": 1,
               "classes": 1, "imagenet_norm": False})
    vol = src.images[:SERVE_SLICES]
    server, thread, url = _start_server(ckpt, dev)
    try:
        reply = _post(url + "/v1/segment", _npz_bytes(img=vol))
        local, _ = load_model_from_ckpt(ckpt, dev)
        near = _check_masks(reply["mask"], segment_volume_2d(
            local, torch.from_numpy(vol).to(dev), batch_size=16),
            "UNet++ request")
    finally:
        _stop_server(server, thread)
    return {"model": "unetpp/resnet34", "decoder": [256, 128, 64, 32, 16],
            "logits_batch": [UNETPP_BATCH, 1, 320, 320],
            "logits_max_abs_err": err, "logits_max_abs": scale,
            "tol": f"{LOGIT_RTOL} * max|logit|", "train_b8_bf16": speed,
            "served_slices": int(vol.shape[0]),
            "served_near_threshold_and_differing_pixels": near}


def run_report(tmp: str) -> dict:
    run = os.path.join(tmp, "run")
    if exporter.main(["--run-dir", run]) != 0:
        raise AssertionError("the report exporter failed")
    with open(os.path.join(run, "report_metrics.json"),
              encoding="utf-8") as f:
        metrics = json.load(f)
    size = os.path.getsize(os.path.join(run, "report.html"))
    if metrics["epochs"] != 2 or size < 1000:
        raise AssertionError(f"report: {metrics}, {size} bytes")
    return {"report_html_bytes": size, "report_metrics": metrics}


def phase_evaluate(model: torch.nn.Module, dev: torch.device,
                   defaults: dict, tmp: str) -> dict:
    """Phase 7: returns the mask kernels' launches on its path (the one
    /v1/segment_kspace request), counted from 0 at its start."""
    t0 = time.perf_counter()
    _set_precision_flags(defaults)
    with open(os.path.join(tmp, "lists", "train.txt"),
              encoding="utf-8") as f:
        src = SliceStore.from_files(f.read().split())
    reset_mask_launches()
    out = {"infer_cli": infer_cli(dev, tmp),
           "evaluate_volume": evaluate_card_vs_cpu(dev, tmp),
           "serve_tta_microbatched": serve_tta_microbatched(model, dev, tmp),
           "unetpp": unetpp_full_width(dev, src, tmp),
           "report": run_report(tmp)}
    launches = mask_launches()
    if _precision_flags() != defaults:
        raise AssertionError(f"phase 7 left the precision flags changed: "
                             f"{_precision_flags()}, not {defaults}")
    emit({"phase": "evaluate", "seconds": time.perf_counter() - t0, **out,
          "launches": launches})
    return launches


# --------------------------------------------------------------------------
# Phase 8: the rest of preprocessing
# --------------------------------------------------------------------------

CC_OPS_PER_PIXEL_SWEEP = 4 * 3   # label_prop.cu: 4 passes x (2 tests, 1 min)


def label_components_bound_ms(shape) -> tuple:
    """Least time for the labels of a uint8 (S, H, W) stack on an H100 and
    what sets it: read the mask and write the int32 labels once (bytes),
    against one pass of the kernel's integer operations over every pixel
    at the INT32 rate. How many sweeps a mask needs is a cost of this
    algorithm, not of the function: see :func:`label_components_sweeps_ms`."""
    s, h, w = shape
    bytes_ms = 5 * s * h * w / HBM_BYTES_PER_S * 1e3
    ops_ms = CC_OPS_PER_PIXEL_SWEEP * s * h * w / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def label_components_sweeps_ms(shape, sweeps: int) -> float:
    """The sweep algorithm's own floor: its integer operations for the
    sweeps these masks took (``sweeps`` summed over the slices, the last,
    checking sweep of each included) at the INT32 rate."""
    _, h, w = shape
    return CC_OPS_PER_PIXEL_SWEEP * h * w * sweeps / INT32_OPS_PER_S * 1e3


def masks_before_components(pair: np.ndarray,
                            dev: torch.device) -> torch.Tensor:
    """The body masks of a k-space volume as the chain makes them, before
    their connected components: uint8 (S, H, W) on ``dev``."""
    pre = MRIKneePreprocessor(device=dev)
    return open_closed_otsu_mask(*pre._clip(pre._upload(pair), True))[0]


def check_labels(m: torch.Tensor, name: str) -> torch.Tensor:
    """label_components on the card against its plain sweeps, bit-equal;
    returns the sweeps each slice took on the card."""
    sweeps = torch.zeros(m.shape[0], dtype=torch.int32, device=m.device)
    got = components.label_components(m, sweeps)
    torch.cuda.synchronize()
    want = components.label_components_reference(m)
    n_diff = int((got != want).sum())
    if n_diff or got.dtype != torch.int32:
        raise AssertionError(f"label_components {name}: {n_diff} labels "
                             f"differ from the plain sweeps ({got.dtype})")
    return sweeps.cpu()


def time_labels(m: torch.Tensor) -> dict:
    """The kernel cold and warm, its plain sweeps by the host clock (they
    read a flag back each sweep), the function's bound, and the sweep
    algorithm's floor for this run's sweeps."""
    sweeps = check_labels(m, f"timed {tuple(m.shape)}")
    kernel = lambda: components.label_components(m)  # noqa: E731
    timers = {"cold": cuda_ms(kernel, cold=True),
              "warm": cuda_ms(kernel, cold=False)}
    bound_ms, bound_by = label_components_bound_ms(tuple(m.shape))
    return {"shape": list(m.shape), "cold_ms": timers["cold"]["ms"],
            "warm_ms": timers["warm"]["ms"], "host_us": host_us(kernel),
            "plain_ms": probe_label_prop.host_ms(
                lambda: components.label_components_reference(m)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / timers["cold"]["ms"],
            "algorithm_floor_ms": label_components_sweeps_ms(
                tuple(m.shape), int(sweeps.sum())),
            "sweeps": sweeps.tolist(), "timers": timers}


def label_components_checks(dev: torch.device) -> dict:
    """Edge cases, phase 3's masks before their components, and the times
    at a volume (phase 3's) and a request (phase 5's first)."""
    cases = component_masks(np.random.default_rng(0))
    edge = {}
    for name, m in cases:
        sweeps = check_labels(torch.from_numpy(m.astype(np.uint8)).to(dev),
                              name)
        edge[name] = int(sweeps.max())
    if edge["maze"] < 300:
        raise AssertionError(f"the serpentine took {edge['maze']} sweeps")
    volume = masks_before_components(synthetic_kspace_pairs(
        seed=1, s=VOLUME[0], h=VOLUME[1], w=VOLUME[2]), dev)
    request = masks_before_components(synthetic_kspace_pairs(
        seed=100, s=SERVE_SLICES, h=VOLUME[1], w=VOLUME[2]), dev)
    return {"cases": len(cases), "max_sweeps_by_case": edge,
            "bit_equal": True, "volume": time_labels(volume),
            "served": time_labels(request)}


def multicoil_volume(dev: torch.device, pair: np.ndarray) -> dict:
    """A (35, 15, 640, 368, 2) volume through preprocess_volume_pairs,
    card against CPU; the card's first and warm seconds and peak memory."""
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0))
    pre = MRIKneePreprocessor(device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    got = pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        pre.preprocess_volume_pairs(pair)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    want = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    cpu_s = time.perf_counter() - t1
    return {"shape": list(pair.shape), "card_first_s": first_s,
            "card_warm_s": warm, "peak_gib_above_start": peak / 2 ** 30,
            "cpu_s": cpu_s, **compare_packs(got, want, pair.shape[0])}


def restored_slices(dev: torch.device, pair: np.ndarray) -> dict:
    """The chain with N4 and NL-means on, card against CPU: first each
    slice's N4 updates per level on the chain's own clipped image and body
    mask, then the packs; tensors are held on the slices whose updates and
    masks agree."""
    kw = dict(out_size=(320, 320), slice_keep=(0.0, 1.0), use_n4=True,
              use_denoise=True)
    card = MRIKneePreprocessor(device=dev, **kw)
    cpu = MRIKneePreprocessor(device="cpu", **kw)
    iters = []
    for pre in (card, cpu):
        img, mk = pre._clip_and_mask(pre._upload(pair), True)
        iters.append(n4_bias_correction(img, mk, return_iterations=True
                                        )[1].cpu())
    same_iters = (iters[0] == iters[1]).all(dim=1)
    if not bool(same_iters.any()):
        raise AssertionError(f"N4 updates differ in every slice: {iters}")
    t1 = time.perf_counter()
    got = card.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = cpu.preprocess_volume_pairs(pair)
    cpu_s = time.perf_counter() - t1
    keep = {k: got[k][same_iters.to(dev)] for k in ("mask", "tensor")}
    held = compare_packs(keep, {k: want[k][same_iters] for k in keep},
                         int(same_iters.sum()), RESTORED_TOL)
    return {"shape": list(pair.shape), "n4_updates_card": iters[0].tolist(),
            "n4_updates_cpu": iters[1].tolist(),
            "slices_with_equal_updates": int(same_iters.sum()),
            "card_s": card_s, "cpu_s": cpu_s, **held}


def multicoil_request(model: torch.nn.Module, dev: torch.device) -> dict:
    """One multi-coil /v1/segment_kspace request against the in-process
    result: returns its reply's check and the mask kernels' launches, counted
    from 0 just before it."""
    kpair = synthetic_multicoil_kspace_pairs(
        seed=3, s=MULTICOIL_REQUEST_SLICES, c=COILS, h=VOLUME[1], w=VOLUME[2])
    body = _npz_bytes(kspace=kpair)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.ckpt")
        save_best(ckpt, model.state_dict(),
                  {"model": "unet", "encoder": "resnet34", "k": 1,
                   "classes": 1, "imagenet_norm": False})
        server, thread, url = _start_server(ckpt, dev)
        try:
            expected = server.RequestHandlerClass.runner.segment_kspace(
                kpair, 0.5, False)
            reset_mask_launches()
            t1 = time.perf_counter()
            out = _post(url + "/v1/segment_kspace", body)
            latency = time.perf_counter() - t1
            launches = mask_launches()
        finally:
            _stop_server(server, thread)
    if set(launches.values()) != {1}:
        raise AssertionError(f"the multi-coil request launched the mask "
                             f"kernels {launches} times, not once each")
    for key in ("mask", "body_mask"):
        if (out[key].shape != (MULTICOIL_REQUEST_SLICES, 320, 320)
                or not np.array_equal(out[key], expected[key])):
            raise AssertionError(f"served multi-coil {key} differs from "
                                 "in-process")
    if not out["body_mask"].any():
        raise AssertionError("the multi-coil request's body masks are empty")
    return {"request_shape": list(kpair.shape), "request_mb": len(body) / 1e6,
            "latency_s": latency, "launches": launches}


def phase_preprocess_rest(model: torch.nn.Module, dev: torch.device,
                          defaults: dict) -> tuple:
    """Phase 8: returns the kernels-line rows of label_components and
    masked_max_prop, and the mask kernels' launches on the multi-coil
    request."""
    t0 = time.perf_counter()
    f32 = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False,
           "cudnn_deterministic": True}
    _set_precision_flags(f32)   # the chains card vs CPU in f32
    cc = label_components_checks(dev)
    components.reset_launches()
    probe = probe_label_prop.probe(dev)
    probe_launches = components.LAUNCHES["masked_max_prop"]
    if probe_launches < 1:
        raise AssertionError("the probe launched masked_max_prop no time")
    pair = synthetic_multicoil_kspace_pairs(seed=2, s=VOLUME[0], c=COILS,
                                            h=VOLUME[1], w=VOLUME[2])
    volume = multicoil_volume(dev, pair)
    mid = (pair.shape[0] - RESTORED_SLICES) // 2
    restored = restored_slices(dev, pair[mid:mid + RESTORED_SLICES])
    del pair
    _set_precision_flags(defaults)
    request = multicoil_request(model, dev)
    emit({"phase": "preprocess_rest", "seconds": time.perf_counter() - t0,
          "chain_flags": f32, "label_components": cc,
          "masked_max_prop": probe, "multicoil_volume": volume,
          "n4_nl_means": restored, "multicoil_request": request})
    source = "mri_acl_imagesegmentation_adsp_tpu_torch/csrc/label_prop.cu"
    replaces = "scripts/probe_pallas_roll.py:50"
    served = {k: cc["served"][k] for k in ("shape", "cold_ms", "warm_ms",
                                           "host_us", "plain_ms", "bound_ms",
                                           "bound_by")}
    cc_row = {"name": "label_components", "route": "cuda", "source": source,
              "replaces": replaces, "launches": None, "max_abs_err": 0.0,
              "ms": cc["volume"]["cold_ms"],
              "plain_ms": cc["volume"]["plain_ms"],
              "bound_ms": cc["volume"]["bound_ms"],
              "bound_by": cc["volume"]["bound_by"], "library_ms": None,
              "shape": cc["volume"]["shape"],
              "warm_ms": cc["volume"]["warm_ms"],
              "host_us": cc["volume"]["host_us"],
              "algorithm_floor_ms": cc["volume"]["algorithm_floor_ms"],
              "sweeps_per_slice": cc["volume"]["sweeps"],
              "served_shape": served}
    prop_row = {"name": "masked_max_prop", "route": "cuda", "source": source,
                "replaces": replaces, "launches": probe_launches,
                "launches_by_path": {"probe": probe_launches},
                "max_abs_err": 0.0, "ms": probe["ms"],
                "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
                "bound_by": probe["bound_by"], "library_ms": None,
                "shape": probe["shape"], "iters": probe["iters"],
                "warm_ms": probe["warm_ms"],
                "serial_floor_cluster_ms": probe["serial_floor_cluster_ms"],
                "serial_floor_one_sm_ms": probe["serial_floor_one_sm_ms"]}
    return cc_row, prop_row, request["launches"]


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi, defaults = phase_setup()
    phase_build()
    row = phase_kernel(dev)
    phase_preprocess(dev)
    model = phase_model(dev)
    by_path = {"serve": phase_serve(model, dev, defaults)}
    if min(by_path["serve"].values()) < 1:
        raise AssertionError(f"the main path launched a mask kernel no "
                             f"time: {by_path['serve']}")
    with tempfile.TemporaryDirectory() as tmp:
        by_path["train"] = phase_train(dev, defaults, tmp)
        by_path["evaluate_serve"] = phase_evaluate(model, dev, defaults, tmp)
    if set(by_path["evaluate_serve"].values()) != {1}:
        raise AssertionError(f"phase 7 launched the mask kernels "
                             f"{by_path['evaluate_serve']} times, not once")
    cc_row, prop_row, by_path["multicoil_serve"] = phase_preprocess_rest(
        model, dev, defaults)
    for r in (row, cc_row):
        r["launches"] = by_path["serve"][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()}
    emit({"kernels": [row, cc_row, prop_row]})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - t0})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
