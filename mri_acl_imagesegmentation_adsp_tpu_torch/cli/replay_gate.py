"""Real-data Dice-parity replay gate.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/replay_gate.py``.
The reference commits one training run on 973 real fastMRI knee volumes,
best val Dice 0.97473, with its ``args.json``. The gate replays that run's
configuration through the port's launcher (``cli/launcher.py``: preprocess
the raw dataset, the 80/20 seed-42 split, training with the ``args.json``
hyperparameters; the launcher flags are the JAX gate's, built the same
way) and holds the best val Dice to the parity bar. ``--args-json`` names
the reference's file (the JAX gate's default is a path on its own
machine). ``--synthetic N`` runs the same gate on N synthetic ``.h5``
volumes (``utils/synthetic.py``, the test oracle's generator and seed)
with a bar suited to the small corpus. ``--device`` is passed on to the
launcher when given (its default is ``cuda``). Reading and writing ``.h5``
needs h5py; without it the gate raises an ImportError that names it.

  FASTMRI_ROOT=/path/to/singlecoil python -m \\
      mri_acl_imagesegmentation_adsp_tpu_torch.cli.replay_gate \\
      --args-json runs/fastmri_unet/args.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

# args.json keys that name the run's hyperparameters (paths are local to
# the machine that trained the reference run and are not replayed)
_HYPERPARAM_KEYS = (
    "k", "aug", "model", "encoder", "encoder_weights", "classes",
    "imagenet_norm", "batch_size", "epochs", "lr", "weight_decay",
    "workers", "loss", "amp", "seed", "logger", "save_val_probs",
    "max_grad_norm",
)

PARITY_DICE = 0.97  # just under the reference's 0.97473 best


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Replay the reference run config on real fastMRI data "
                    "and assert Dice parity.")
    p.add_argument("--args-json", type=Path, required=True,
                   help="Reference args.json to replay.")
    p.add_argument("--dataset-root", type=Path, default=None,
                   help="Raw fastMRI single-coil root (default: the "
                        "launcher's, from the config / FASTMRI_ROOT).")
    p.add_argument("--work-dir", type=Path, default=Path("replay_gate"),
                   help="Where artifacts/lists/run outputs are written.")
    p.add_argument("--min-dice", type=float, default=PARITY_DICE,
                   help="Parity bar on best val Dice.")
    p.add_argument("--skip-preprocess", action="store_true",
                   help="Reuse an existing artifact dir under work-dir.")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="Dry-run on N synthetic volumes instead of real "
                        "data (lower your --min-dice accordingly).")
    p.add_argument("--epochs", type=int, default=None,
                   help="Override epoch count (dry runs only; the real "
                        "gate uses the args.json value).")
    p.add_argument("--device", default=None,
                   help="passed on to the launcher (its default: cuda)")
    return p


def _make_synthetic_dataset(root: Path, n_volumes: int) -> None:
    import numpy as np

    from ..utils.synthetic import (synthetic_kspace_volume,
                                   write_fake_fastmri_h5)
    rng = np.random.default_rng(97)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_volumes):
        ksp, _ = synthetic_kspace_volume(rng, s=10, h=64, w=48)
        write_fake_fastmri_h5(str(root / f"synthetic_{i:03d}.h5"), ksp)


def launcher_flags(ref: dict, work: Path, epochs: int, synthetic: bool,
                   skip_preprocess: bool, dataset_root) -> list:
    """The launcher's flags for the reference ``args.json`` ``ref``, as
    the JAX gate builds them."""
    flags = [
        "--artifact-dir", str(work / "artifacts"),
        "--list-dir", str(work / "lists"),
        "--out-dir", str(work / "run"),
        # the reference preprocess defaults (launcher defaults == reference)
        "--split-ratio", "0.8", "--split-seed", "42",
        # hyperparameters straight from args.json
        "--k", str(ref["k"]), "--aug", ref["aug"],
        "--model", ref["model"], "--encoder", ref["encoder"],
        "--encoder-weights", ref["encoder_weights"],
        "--classes", str(ref["classes"]),
        "--batch-size", str(ref["batch_size"]),
        "--epochs", str(epochs), "--lr", str(ref["lr"]),
        "--weight-decay", str(ref["weight_decay"]),
        "--workers", str(ref["workers"]), "--loss", ref["loss"],
        "--seed", str(ref["seed"]), "--logger", ref["logger"],
        "--max-grad-norm", str(ref["max_grad_norm"]),
    ]
    if ref["imagenet_norm"]:
        flags.append("--imagenet-norm")
    if ref["save_val_probs"]:
        flags.append("--save-val-probs")
    if not ref["amp"]:
        flags.append("--no-amp")
    if synthetic:
        # synthetic fixtures are small: keep every slice
        flags += ["--height", "48", "--width", "48", "--slice-keep", "0.0,1.0"]
    if skip_preprocess:
        flags.append("--skip-preprocess")
    elif dataset_root:
        flags += ["--dataset-root", str(dataset_root)]
    return flags


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .launcher import main as launcher_main

    ns = build_parser().parse_args(argv)
    ref = json.loads(Path(ns.args_json).read_text())
    missing = [k for k in _HYPERPARAM_KEYS if k not in ref]
    if missing:
        raise SystemExit(f"args.json lacks keys: {missing}")

    work = Path(ns.work_dir).resolve()
    dataset_root = ns.dataset_root
    if ns.synthetic:
        dataset_root = work / "synthetic_raw"
        _make_synthetic_dataset(dataset_root, ns.synthetic)

    epochs = ns.epochs if (ns.epochs and ns.synthetic) else ref["epochs"]
    flags = launcher_flags(ref, work, epochs, bool(ns.synthetic),
                           ns.skip_preprocess, dataset_root)
    if ns.device:
        flags += ["--device", ns.device]
    rc = launcher_main(flags)
    if rc != 0:
        raise SystemExit(f"launcher failed (rc={rc})")

    summary = json.loads((work / "run" / "summary.json").read_text())
    best = float(summary["best"]["val_dice"])
    bar = ns.min_dice
    verdict = "PASS" if best >= bar else "FAIL"
    print(json.dumps({"gate": "dice_parity", "best_val_dice": best,
                      "min_dice": bar, "reference_dice": 0.97473,
                      "verdict": verdict}))
    return 0 if best >= bar else 1


if __name__ == "__main__":
    sys.exit(main())
