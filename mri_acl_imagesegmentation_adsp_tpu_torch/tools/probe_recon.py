"""Where a T2 and a DWI case's time goes on the card.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_recon
        [--out FILE.json]

The protocol cases, made from a seed: T2 at ``bench.py:bench_grappa``'s
size (3 averages, 10 slices, 20 coils, 640 x 368, every third phase-encode
line, 32 ACS lines) and DWI at ``scripts/measure_dwi.py``'s (51 averages,
8 slices, 12 coils, 200 x 104, every second line and a 16-line centre
band; the EPI timing read from an ISMRMRD header of that matrix). After a
warm-up case, each case's stages (``recon/t2.py`` and ``recon/dwi.py``'s
own stage functions) are timed by the host clock with the card
synchronized at each edge, and one whole case is traced by
``torch.profiler``: the card's busy milliseconds (kernels and copies),
its idle share of the case's wall time and the costliest CUDA kernels.

Prints the card's ``nvidia-smi`` line and one JSON line, and writes the line
to ``--out``. Exits non-zero without a card.
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

from ..data.recon_data import get_regridding_params
from ..recon import dwi, t2
from ..utils.cuda_timing import _trace
from ..utils.device import f32_on_card

T2_CASE = (3, 10, 20, 640, 368)   # averages, slices, coils, ro, pe
T2_R, T2_ACS = 3, 32       # every third PE line kept; ACS lines
DWI_CASE = (51, 8, 12, 200, 104)
DWI_R = 2
DWI_HDR = """<?xml version="1.0"?>
<ismrmrdHeader xmlns="http://www.ismrm.org/ISMRMRD">
  <encoding>
    <encodedSpace><matrixSize><x>{ro}</x><y>{pe}</y><z>1</z></matrixSize></encodedSpace>
    <reconSpace><matrixSize><x>{ro}</x><y>{ro}</y><z>1</z></matrixSize></reconSpace>
    <trajectoryDescription>
      <userParameterLong><name>rampUpTime</name><value>100</value></userParameterLong>
      <userParameterLong><name>rampDownTime</name><value>100</value></userParameterLong>
      <userParameterLong><name>flatTopTime</name><value>400</value></userParameterLong>
      <userParameterLong><name>acqDelayTime</name><value>10</value></userParameterLong>
      <userParameterLong><name>echoSpacing</name><value>1</value></userParameterLong>
    </trajectoryDescription>
  </encoding>
</ismrmrdHeader>"""
TOP_KERNELS = 8


def complex_normal(rng, shape, scale: float = 1.0) -> np.ndarray:
    """Seeded complex64 noise, drawn as float32 straight into the buffer."""
    out = np.empty(shape, np.complex64)
    rng.standard_normal(dtype=np.float32, out=out.view(np.float32))
    if scale != 1.0:
        out *= scale
    return out


def t2_protocol_case(seed: int, shape=T2_CASE, r: int = T2_R,
                     acs: int = T2_ACS) -> tuple:
    """``(kspace, calib)``: complex64 k-space with every ``r``-th
    phase-encode line kept, and an ``acs``-line calibration."""
    rng = np.random.default_rng(seed)
    k = complex_normal(rng, shape)
    keep = np.zeros(shape[-1], bool)
    keep[::r] = True
    k[..., ~keep] = 0
    return k, complex_normal(rng, (shape[1], shape[2], shape[3], acs))


def dwi_protocol_case(seed: int, shape=DWI_CASE, r: int = DWI_R) -> tuple:
    """``(kspace, calibration, coil_sens_maps, EPI timing)``: every
    ``r``-th line and a 16-line centre band kept."""
    rng = np.random.default_rng(seed)
    _, slices, coils, ro, pe = shape
    k = complex_normal(rng, shape, 0.1)
    keep = np.zeros(pe, bool)
    keep[::r] = True
    keep[pe // 2 - 8: pe // 2 + 8] = True
    k[..., ~keep] = 0
    calib = complex_normal(rng, (slices, coils, ro, pe), 0.1)
    sens = complex_normal(rng, (slices, coils, ro, pe))
    return k, calib, sens, get_regridding_params(DWI_HDR.format(ro=ro,
                                                                pe=pe))


def _stages(steps) -> dict:
    """Seconds of each ``(name, fn)`` step by the host clock, the card
    synchronized at each edge; each ``fn`` takes the previous result."""
    out, value = {}, None
    for name, fn in steps:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        value = fn(value)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t1
    return out


def t2_stages(dev: torch.device, k: np.ndarray, calib: np.ndarray) -> dict:
    """``t2_reconstruction``'s stages; ``grams`` is timed on its own too
    (the ``weights`` stage computes it again)."""
    state = {}

    def keep(name, value):
        state[name] = value
        return value
    with f32_on_card(dev):
        return _stages([
            ("geometry", lambda _: keep("g", t2._t2_geometry(k, dev))),
            ("grams", lambda _: state["g"][0].compute_grams(
                np.transpose(calib, (0, 3, 1, 2)))),
            ("weights", lambda _: keep("w", t2._t2_weights(state["g"],
                                                           calib))),
            ("upload", lambda _: t2._t2_upload(k, None, dev)),
            ("fill", lambda kd: t2._t2_fill(kd, state["g"], state["w"],
                                            t2.T2_STAGE_BYTES)),
            ("image_and_download",
             lambda kp: t2._t2_image(kp, 0.0).cpu().numpy()),
        ])


def dwi_stages(dev: torch.device, k, calib, sens, hdr) -> dict:
    """``dwi_reconstruction``'s stages."""
    grid = dwi.get_grid_mat(hdr).astype(np.float32)
    state = {}
    with f32_on_card(dev):
        return _stages([
            ("weights", lambda _: state.update(gw=dwi._dwi_weights(
                k, calib, hdr, grid, dev))),
            ("upload_and_regrid",
             lambda _: dwi._dwi_upload(k, grid, None, dev)),
            ("fill_ifft_combine_and_download",
             lambda kg: dwi._dwi_magnitudes(kg, sens, *state["gw"],
                                            dwi.DWI_STAGE_BYTES)),
            ("host_maps", dwi._dwi_maps),
        ])


def card_busy(run) -> dict:
    """One traced call of ``run``: its wall seconds, the card's busy
    milliseconds (every kernel and copy), the idle share, and the
    costliest kernels."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    seen = _trace(run, runs=1, pad_s=0.02)
    busy_ms = sum(us for _, us in seen.values()) / 1e3
    top = sorted(seen.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    return {"wall_s": wall, "card_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / 1e3 / wall),
            "top_kernels": [{"name": n, "launches": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


def probe(dev: torch.device) -> dict:
    k, calib = t2_protocol_case(0)
    run_t2 = lambda: t2.t2_reconstruction(k, calib, device=dev)  # noqa: E731
    run_t2()
    out = {"t2": {"case": list(T2_CASE), "stages_s": t2_stages(dev, k,
                                                               calib),
                  **card_busy(run_t2)}}
    del k, calib
    dk, dcal, sens, hdr = dwi_protocol_case(1)
    run_dwi = lambda: dwi.dwi_reconstruction(  # noqa: E731
        dk, dcal, sens, hdr, device=dev)
    run_dwi()
    out["dwi"] = {"case": list(DWI_CASE),
                  "stages_s": dwi_stages(dev, dk, dcal, sens, hdr),
                  **card_busy(run_dwi)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_recon needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    line = json.dumps({"card": smi, **probe(torch.device("cuda"))})
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
