"""Where the disk(2) open/close kernel's time goes on the card.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_open_close
        [--earlier-source FILE.cu] [--out FILE.json]

At a volume's (35, 640, 368) and a served request's (8, 640, 368) shape, on
one random mask of density 0.5, with ``utils/cuda_timing.py``'s timer (the
host out of the window), cold (L2 flushed) and warm:

- the kernel as the wrapper launches it;
- its phase-clock build (``csrc/open_close.cu`` with
  ``-DOPEN_CLOSE_PHASE_CLOCK``): its own time beside the plain build's, and
  per-block phase times from the card's nanosecond timer;
- at the volume, the kernel at each band height of ``BAND_SWEEP``;
- an empty kernel between the same events: what a launch costs alone;
- with ``--earlier-source``, an earlier design of ``open_close.cu`` whose
  entry point is ``open_close_u8(in, out, S, H, W, stream)``, such as the
  first one (``git show 6853ed1:<path>`` with <path>
  ``mri_acl_imagesegmentation_adsp_tpu_torch/csrc/open_close.cu``); it is
  held bit-equal to the plain version and timed the same way.

The builds are one ``nvcc`` each, started together, into
``build/torch_kernels/probe/``. Prints the card's ``nvidia-smi`` line, then
one JSON line per shape, and writes the same to ``--out``. Exits non-zero
without a card, or when a build fails or a result differs from the plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import _build, morphology
from ..utils.cuda_timing import FLUSH_BYTES, cuda_ms, sleep_cycles_per_us

VOLUME = (35, 640, 368)
SERVE_SLICES = 8
BAND_SWEEP = (8, 16, 32, 64, 128)
PHASES = ("load", "words", "pass1_erode", "pass2_dilate", "pass3_dilate",
          "pass4_erode", "store")
PHASE_CLOCK_MAX_BLOCKS = 8192   # kStampedBlocks in open_close.cu


def build_variant(source: Path, defines: tuple = ()) -> ctypes.CDLL:
    """``source`` compiled with ``_build.NVCC_FLAGS`` and the macros
    ``defines`` into ``build/torch_kernels/probe/``, and loaded."""
    flags = (*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "probe" / f"lib{source.stem}_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *flags, "-o", str(out),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def _launcher(fn, args):
    """A call of the C entry point ``fn`` on torch's current stream that
    raises on a CUDA error."""
    def launch():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")
    return launch


def times(fn) -> dict:
    """Cold and warm card milliseconds of ``fn``, with each timer's sleep
    and late runs (``cuda_timing.cuda_ms``)."""
    return {"cold": cuda_ms(fn, cold=True), "warm": cuda_ms(fn, cold=False)}


def phase_clock(lib: ctypes.CDLL, x: torch.Tensor, cold: bool) -> dict:
    """One launch of the phase-clock build, its stamps read back: the mean
    and largest time of each phase of ``PHASES`` over the blocks, the time
    from the first block's start to the last block's start, and to the last
    block's last store issued. The card sleeps before the launch (and, cold,
    zeroes 256 MB first), as ``cuda_ms`` does."""
    s, h, w = x.shape
    rows, n_bands = morphology.band_plan(s, h)
    blocks = s * n_bands
    if blocks > PHASE_CLOCK_MAX_BLOCKS:
        raise ValueError(f"{blocks} blocks: the phase clock stamps at most "
                         f"{PHASE_CLOCK_MAX_BLOCKS}")
    out = torch.empty_like(x)
    launch = _launcher(lib.open_close_u8, (x.data_ptr(), out.data_ptr(), s,
                                           h, w, rows, n_bands))
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=x.device)
             if cold else None)
    for _ in range(3):   # the stamps of the last launch are read
        torch.cuda.synchronize()
        if cold:
            flush.zero_()
        torch.cuda._sleep(int(200 * sleep_cycles_per_us()))
        launch()
    torch.cuda.synchronize()
    if not torch.equal(out, morphology.open_close_reference(x)):
        raise AssertionError("the phase-clock build differs from the plain "
                             "version")
    stamps = np.zeros((blocks, len(PHASES) + 1), np.uint64)
    rc = lib.open_close_phase_ns(stamps.ctypes.data, blocks)
    if rc != 0:
        raise RuntimeError(f"reading the phase clock failed: CUDA {rc}")
    t = stamps.astype(np.int64)
    d = np.diff(t, axis=1) / 1e3
    return {"blocks": blocks,
            "phase_us_mean": dict(zip(PHASES, d.mean(0).tolist())),
            "phase_us_max": dict(zip(PHASES, d.max(0).tolist())),
            "last_start_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3,
            "last_store_issued_us": float(t[:, -1].max() - t[:, 0].min())
            / 1e3}


def probe_shape(shape, clock: ctypes.CDLL, earlier, rng) -> dict:
    x = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8)).cuda()
    want = morphology.open_close_reference(x)
    s, h, w = shape
    rows, n_bands = morphology.band_plan(s, h)
    res = {"shape": list(shape), "band_rows": rows,
           "kernel": times(lambda: morphology.open_close(x))}
    out = torch.empty_like(x)
    stamped = _launcher(clock.open_close_u8, (x.data_ptr(), out.data_ptr(),
                                              s, h, w, rows, n_bands))
    res["phase_clock_build"] = times(stamped)
    res["phase_clock"] = {"cold": phase_clock(clock, x, cold=True),
                          "warm": phase_clock(clock, x, cold=False)}
    res["empty_kernel"] = times(lambda: torch.cuda._sleep(0))
    if s == VOLUME[0]:
        res["band_rows_cold_ms"] = {
            str(r): cuda_ms(lambda: morphology._open_close(x, r),
                            cold=True)["ms"] for r in BAND_SWEEP}
    if earlier is not None:
        launch = _launcher(earlier.open_close_u8,
                           (x.data_ptr(), out.data_ptr(), s, h, w))
        out.zero_()
        launch()
        if not torch.equal(out, want):
            raise AssertionError("the earlier design differs from the plain "
                                 "version")
        res["earlier"] = times(launch)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier-source", type=Path, default=None,
                    help="an earlier open_close.cu to time beside this one")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON lines here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the probe needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    source = _build.CSRC / "open_close.cu"
    with ThreadPoolExecutor(3) as pool:
        plain = pool.submit(morphology.load_library)
        clock = pool.submit(build_variant, source, ("OPEN_CLOSE_PHASE_CLOCK",))
        earlier = (pool.submit(build_variant, args.earlier_source)
                   if args.earlier_source else None)
        plain.result()
        clock = clock.result()
        earlier = earlier.result() if earlier else None
    clock.open_close_u8.argtypes = ([ctypes.c_void_p] * 2
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    clock.open_close_u8.restype = ctypes.c_int
    clock.open_close_phase_ns.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clock.open_close_phase_ns.restype = ctypes.c_int
    if earlier is not None:
        earlier.open_close_u8.argtypes = ([ctypes.c_void_p] * 2
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        earlier.open_close_u8.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    lines = [json.dumps({"card": smi, "torch": torch.__version__,
                         "sleep_cycles_per_us": sleep_cycles_per_us()})]
    for shape in (VOLUME, (SERVE_SLICES,) + VOLUME[1:]):
        lines.append(json.dumps(probe_shape(shape, clock, earlier, rng)))
        print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
