"""Adapter preview + preprocess CLI.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/main.py`` (the
reference's ``src/main.py:37-96,151-248``): ``--dataset fastmri --root
... [--with-preproc]`` previews the first records (sizes, shapes, meta),
then, when the preprocess flags follow, packs the volumes through
``data/packer.py:build_preprocess``. Plus ``--device`` (default ``cuda``)
for the preprocessing. Reading ``.h5`` needs h5py; without it the adapter
raises an ImportError that names it.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.main \\
      --dataset fastmri --root /data/singlecoil \\
      --root_dir /data/singlecoil --out_dir artifacts/fastmri_knee
"""

from __future__ import annotations

import argparse
import os
from pprint import pprint
from typing import Optional, Sequence, Tuple

from ..data.adapters import BaseAdapter, FastMRISinglecoilAdapter
from ..data.packer import build_preprocess
from ..data.preprocess import MRIKneePreprocessor
from ..data.trainer_dataset import TrainerDataset


def build_adapter(name: str, args) -> Tuple[TrainerDataset, BaseAdapter]:
    if name.lower() != "fastmri":
        raise ValueError("Only the fastMRI single-coil dataset is supported.")
    root = args.root or os.getenv("FASTMRI_ROOT")
    if not root:
        raise ValueError("Missing root for fastMRI. Set FASTMRI_ROOT or pass "
                         "--root")
    adapter = FastMRISinglecoilAdapter(root_dir=root)
    pre = (MRIKneePreprocessor(out_size=(320, 320),
                               device=getattr(args, "device", "cuda"))
           if args.with_preproc else None)
    return TrainerDataset(adapter, preprocessor=pre), adapter


def preview(ds, n: int = 3) -> None:
    print(f"Dataset size: {len(ds)}")
    for i in range(min(n, len(ds))):
        sample = ds[i]
        meta = sample.get("meta", {})
        img = sample.get("image")
        msk = sample.get("mask")
        print(f"[{i}] adapter={meta.get('adapter')} "
              f"img={tuple(getattr(img, 'shape', ())) or None} "
              f"mask={tuple(getattr(msk, 'shape', ())) or None} "
              f"label={sample.get('label')}")
        pprint({k: v for k, v in meta.items() if k != "adapter"})


def parse_args_adapter(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description="Adapter demo entrypoint (fastMRI only)")
    p.add_argument("--dataset", required=True, choices=["fastmri"])
    p.add_argument("--root", default=None,
                   help="Override root dir (takes precedence over "
                        "FASTMRI_ROOT)")
    p.add_argument("--with-preproc", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    return p.parse_known_args(argv)


def parse_args_preprocess(argv: Optional[Sequence[str]] = None):
    if not argv:
        return None
    ap = argparse.ArgumentParser(
        description="Preprocess fastMRI knee (single-coil) -> "
                    "tensor/preview/meta")
    ap.add_argument("--root_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--slice_keep", type=str, default="0.3,0.7")
    ap.add_argument("--use_n4", action="store_true")
    ap.add_argument("--use_denoise", action="store_true")
    ap.add_argument("--clip", type=str, default="1.0,99.5")
    ap.add_argument("--preview_max", type=int, default=8)
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip volumes whose pack is already complete "
                         "(stats.json present)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    adapter_args, remaining = parse_args_adapter(argv)
    dataset, adapter = build_adapter(adapter_args.dataset, adapter_args)
    preview(dataset, n=3)
    preprocess_args = parse_args_preprocess(remaining)
    if preprocess_args is None:
        return
    preprocess_args.device = adapter_args.device
    results = build_preprocess(preprocess_args, adapter=adapter)
    if not results:
        print("No volume matched the preprocessing filters.")
        return
    print(f"Preprocess finished for {len(results)} volume(s), stored at "
          f"{preprocess_args.out_dir}")


if __name__ == "__main__":
    main()
