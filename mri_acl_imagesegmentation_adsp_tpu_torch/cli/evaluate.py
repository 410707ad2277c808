"""Score reconstructions against their targets.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/evaluate.py`` (the
prostate code's ``evaluate.py:101-169``): walk the target dir, pair each
``.h5`` with the same name under the predictions dir, crop both to the
target's width square, and report MSE, NMSE, PSNR and SSIM as running
means +/- 2 std, filtered by ``--acquisition`` / ``--acceleration``; plus
``--device`` (default ``cuda``, which raises without a card), where the
SSIM windows run. Reading the files needs h5py.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.evaluate \\
      --target-path gt_dir --predictions-path pred_dir \\
      [--challenge singlecoil] [--acquisition X] [--acceleration 4]
"""

from __future__ import annotations

import argparse
import functools
import pathlib

from ..data.transforms import center_crop
from ..metrics import METRIC_FUNCS, Metrics, ssim
from ..native import import_h5py
from ..utils.device import resolve_device


def evaluate(args, recons_key: str) -> Metrics:
    h5py = import_h5py("cli.evaluate")
    dev = resolve_device(getattr(args, "device", "cuda"))
    metrics = Metrics({**METRIC_FUNCS,
                       "SSIM": functools.partial(ssim, device=dev)})
    for tgt_file in args.target_path.iterdir():
        with h5py.File(tgt_file, "r") as target, h5py.File(
                args.predictions_path / tgt_file.name, "r") as recons:
            if args.acquisition and args.acquisition != target.attrs.get(
                    "acquisition"):
                continue
            if args.acceleration and target.attrs.get(
                    "acceleration") != args.acceleration:
                continue
            tgt = target[recons_key][()]
            rec = recons["reconstruction"][()]
            tgt = center_crop(tgt, (tgt.shape[-1], tgt.shape[-1]))
            rec = center_crop(rec, (tgt.shape[-1], tgt.shape[-1]))
            metrics.push(tgt, rec)
    return metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Evaluate reconstructions (PyTorch)")
    p.add_argument("--target-path", type=pathlib.Path, required=True)
    p.add_argument("--predictions-path", type=pathlib.Path, required=True)
    p.add_argument("--challenge", default="multicoil",
                   choices=["singlecoil", "multicoil"])
    p.add_argument("--acquisition", default=None)
    p.add_argument("--acceleration", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where SSIM runs; cuda "
                        "without a card raises")
    args = p.parse_args(argv)
    recons_key = ("reconstruction_rss" if args.challenge == "multicoil"
                  else "reconstruction_esc")
    print(evaluate(args, recons_key))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
