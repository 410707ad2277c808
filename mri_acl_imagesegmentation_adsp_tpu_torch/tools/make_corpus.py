"""Make the synthetic knee corpus as training packs, in memory.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.make_corpus \\
        --out /data/corpus/packs [--volumes 125] [--slices 112] \\
        [--height 368] [--width 320] [--seed 2024] [--device cuda]

The counterpart of ``scripts/make_corpus.py`` with its flags and defaults:
volume ``i`` is made from ``seed + i`` (``utils/synthetic.py``, the same
numpy stream as the script's oracle generator). The script writes each as
a fastMRI ``.h5`` holding the k-space and the images as its
``reconstruction_esc`` target, and the JAX launcher's preprocess stage then
packs the target, which outranks the k-space. Here the volume goes straight
to ``data/packer.py:pack_kspace_volume`` with the launcher's preprocess
defaults (320x320, slice band 0.3-0.7, clip 1-99.5 %, six previews) as
that target, so no ``.h5`` and no ``h5py`` is needed. The pack of volume
``i`` is ``<out>/vol{i:04d}/volume.npz``, the
name the JAX route gives the pack of ``vol{i:04d}.h5``, so the launcher's
seeded split forms the JAX run's train and val lists.

Resumable: a pack whose ``volume.npz`` and ``stats.json`` (written last)
exist is skipped; each pack is written into ``vol{i:04d}.tmp`` and renamed,
and a ``.tmp`` left by a crash is removed first. Each pack launches each
body-mask kernel once on a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Dict

from ..data.packer import pack_kspace_volume
from ..data.preprocess import MRIKneePreprocessor
from ..ops.kernels import components, morphology
from ..utils.device import resolve_device
from ..utils.synthetic import synthetic_knee_volume


def mask_launches() -> Dict[str, int]:
    """The body mask kernels' launches so far in this process (each
    wrapper counts where it launches its kernel: none on the CPU)."""
    return {"open_close": morphology.LAUNCHES,
            "label_components": components.LAUNCHES["label_components"]}


def corpus_preprocessor(device, out_size=(320, 320),
                        slice_keep=(0.3, 0.7)) -> MRIKneePreprocessor:
    """The launcher's preprocess defaults (``cli/launcher.py``); a 3-D
    corpus keeps every slice (``slice_keep=(0.0, 1.0)``)."""
    return MRIKneePreprocessor(out_size=out_size, slice_keep=slice_keep,
                               clip_percentiles=(1.0, 99.5), device=device)


def pack_corpus_volume(preprocessor: MRIKneePreprocessor, seed: int,
                       out_dir: str, slices: int = 112, height: int = 368,
                       width: int = 320, preview_max: int = 6) -> Dict:
    """Make the volume of ``seed`` and pack its images, the target, into
    ``out_dir`` through ``pack_kspace_volume``."""
    images = synthetic_knee_volume(seed, slices, height, width)
    return pack_kspace_volume(preprocessor, None, out_dir,
                              preview_max=preview_max, target=images)


def _complete(d: str) -> bool:
    return (os.path.isfile(os.path.join(d, "volume.npz"))
            and os.path.isfile(os.path.join(d, "stats.json")))


def make_corpus(out: str, volumes: int = 125, slices: int = 112,
                height: int = 368, width: int = 320, seed: int = 2024,
                device="cuda", slice_keep=(0.3, 0.7)) -> Dict:
    """Pack ``volumes`` volumes into ``out``, each the slices of its band
    ``slice_keep``; returns how many were made and skipped, the slices per
    new pack, the seconds taken and the mask kernels' launches."""
    pre = corpus_preprocessor(resolve_device(device), slice_keep=slice_keep)
    before = mask_launches()
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    made, skipped, slices_out = 0, 0, []
    for i in range(volumes):
        final = os.path.join(out, f"vol{i:04d}")
        if _complete(final):
            skipped += 1
            continue
        tmp = final + ".tmp"
        for stale in (tmp, final):
            if os.path.isdir(stale):
                shutil.rmtree(stale)
        info = pack_corpus_volume(pre, seed + i, tmp, slices, height, width)
        os.replace(tmp, final)
        made += 1
        slices_out.append(info["num_slices"])
        if (i + 1) % 10 == 0:
            print(f"[corpus] {i + 1}/{volumes} volumes "
                  f"({time.perf_counter() - t0:.0f}s)")
    secs = time.perf_counter() - t0
    print(f"[corpus] done: {made} packed, {skipped} already there, "
          f"{volumes} volumes of {slices} slices at {height}x{width} "
          f"({secs:.1f}s)")
    return {"made": made, "skipped": skipped, "slices_per_pack": slices_out,
            "seconds": secs, "mask_kernel_launches": {
                k: v - before[k] for k, v in mask_launches().items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--volumes", type=int, default=125)
    ap.add_argument("--slices", type=int, default=112)
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ns = ap.parse_args(argv)
    make_corpus(ns.out, ns.volumes, ns.slices, ns.height, ns.width, ns.seed,
                ns.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
