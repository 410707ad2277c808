#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the serving daemon's ``/v1/segment_kspace``: raw
single-coil k-space -> iFFT magnitude -> percentile clip -> Otsu body mask
(its disk(2) open/close in the CUDA kernel ``csrc/open_close.cu``) ->
resize and z-score -> ResNet34 U-Net at full width (320x320 input, decoder
256-128-64-32-16) -> mask. The weights are random, made from a seed.

Phases, each printing one JSON line with its seconds:
  0  setup: watchdog, the card's name and power limit, TF32 off for the
     parity phases 2-4;
  1  build the CUDA kernel with nvcc, with what ptxas says of it;
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
     checked against the in-process result and shown to launch the kernel
     exactly once.
Then a ``kernels`` line, the ``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any mismatch raises and the script exits
non-zero; without a card it exits non-zero and prints no result, and a
watchdog turns a hang into a non-zero exit with a traceback.
"""

from __future__ import annotations

import copy
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
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
    segment_volume_2d, threshold_probs)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
    _build, morphology)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
    save_best)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.cuda_timing import (
    cuda_ms, host_us)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def phase_build() -> None:
    t0 = time.perf_counter()
    fresh = not _build.library_path("open_close").exists()
    morphology.load_library()
    report = _build.ptxas_report("open_close")
    kernels = [{"registers": int(r), "spill_stores_bytes": int(st),
                "spill_loads_bytes": int(ld)}
               for st, ld, r in zip(
                   re.findall(r"(\d+) bytes spill stores", report),
                   re.findall(r"(\d+) bytes spill loads", report),
                   re.findall(r"Used (\d+) registers", report))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": "mri_acl_imagesegmentation_adsp_tpu_torch/csrc/"
                    "open_close.cu", "nvcc": fresh,
          "ptxas": kernels, "ptxas_lines": [
              ln.strip() for ln in report.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]})


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
    before = morphology.LAUNCHES
    t1 = time.perf_counter()
    got = pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    if morphology.LAUNCHES <= before:
        raise AssertionError("the preprocess chain did not launch open_close")
    t1 = time.perf_counter()
    pre.preprocess_volume_pairs(pair)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = MRIKneePreprocessor(device="cpu", **kw).preprocess_volume_pairs(
        pair)
    cpu_s = time.perf_counter() - t1
    g_mask, w_mask = got["mask"].cpu(), want["mask"]
    if g_mask.shape != (shape[0], 320, 320) or not bool(w_mask.any()):
        raise AssertionError(f"unexpected mask {tuple(g_mask.shape)}")
    n_diff = int((g_mask != w_mask).sum())
    if n_diff > MASK_DIFF_MAX * w_mask.numel():
        raise AssertionError(f"body masks differ in {n_diff} pixels")
    same = (g_mask == w_mask).flatten(1).all(dim=1)
    g_t, w_t = got["tensor"].cpu(), want["tensor"]
    if not bool(torch.isfinite(g_t).all()):
        raise AssertionError("non-finite preprocessed tensor")
    err = float((g_t[same] - w_t[same]).abs().max())
    if err > TENSOR_TOL * (1.0 + float(w_t[same].abs().max())):
        raise AssertionError(f"preprocessed tensor differs by {err}")
    emit({"phase": "preprocess", "seconds": time.perf_counter() - t0,
          "shape": list(pair.shape), "card_first_s": first_s,
          "card_warm_s": warm_s, "cpu_s": cpu_s,
          "mask_bit_equal": n_diff == 0, "mask_diff_pixels": n_diff,
          "mask_pixels": int(w_mask.numel()),
          "slices_with_equal_masks": int(same.sum()),
          "tensor_max_abs_err": err, "tensor_tol": TENSOR_TOL})


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


def phase_serve(model: torch.nn.Module, dev: torch.device, defaults: dict,
                shape=(SERVE_SLICES,) + VOLUME[1:]) -> int:
    """The main path: returns open_close's launches during the requests.
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
        server = serve.create_server(SimpleNamespace(
            ckpt=ckpt, host="127.0.0.1", port=0, batch_size=16,
            pre_out_size="320,320", warmup_shape=f"{shape[0]},320,320",
            device=str(dev)))
        served_flags = _precision_flags()
        if served_flags["cudnn_allow_tf32"] or served_flags[
                "matmul_allow_tf32"]:
            raise AssertionError(f"the daemon serves with TF32 on: "
                                 f"{served_flags}")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = "http://127.0.0.1:%d" % server.server_address[1]
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            if health.get("status") != "ok":
                raise AssertionError(f"healthz: {health}")
            runner = server.RequestHandlerClass.runner
            expected = [runner.segment_kspace(v, 0.5, False) for v in vols]
            latencies, in_lock = [], []
            morphology.LAUNCHES = 0
            for i, (body, exp) in enumerate(zip(bodies, expected)):
                before = morphology.LAUNCHES
                t1 = time.perf_counter()
                out = _post(url + "/v1/segment_kspace", body)
                latencies.append(time.perf_counter() - t1)
                in_lock.append(runner.last_latency_s)
                if morphology.LAUNCHES != before + 1:
                    raise AssertionError(
                        f"request {i} launched open_close "
                        f"{morphology.LAUNCHES - before} times, not once")
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
            launches = morphology.LAUNCHES
            breakdown = _serve_breakdown(runner, bodies[0])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread still running after shutdown")
    emit({"phase": "serve", "seconds": time.perf_counter() - t0,
          "endpoint": "/v1/segment_kspace", "requests": len(vols),
          "request_shape": list(vols[0].shape),
          "request_mb": len(bodies[0]) / 1e6, "latency_s": latencies,
          "runner_locked_s": in_lock, "breakdown_s": breakdown,
          "precision_flags": served_flags, "open_close_launches": launches})
    return launches


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
    row["launches"] = phase_serve(model, dev, defaults)
    if row["launches"] < 1:
        raise AssertionError("the main path launched open_close no time")
    emit({"kernels": [row]})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - t0})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
