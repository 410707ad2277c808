"""End-to-end launcher: preprocess -> split -> train.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/launcher.py:82-130,
136-345``, with the same flags and defaults (so a JAX run's flags replay),
the same stage gates (``--skip-preprocess`` / ``--skip-split`` /
``--skip-train``), the same split (a seeded shuffle of the sorted pack
list, cut at ``round(n * ratio)`` with at least one volume each side) and
the ``--preset`` overlay, plus ``--device`` (default ``cuda``). Flags
cannot be abbreviated, so an abbreviation cannot slip past the preset's
explicit-flag check.

The preprocess stage reads fastMRI ``.h5`` files, whose adapters are not
ported yet: it raises. Packs made by ``data/packer.py:pack_kspace_volume``
train with ``--skip-preprocess``. The TPU extension flags are accepted and
passed on: ``--resume``, ``--save-resume-every``, ``--save-resume-steps``,
``--resume-keep``, ``--preempt-save``, ``--profile-epochs``, ``--remat``
and ``--encoder-weights <checkpoint>`` run; the trainer refuses the others
(``--ckpt-backend orbax``, ``--ckpt-async``, ``--store-sharded``,
``--data-parallel`` above 1).

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.launcher \\
      --skip-preprocess --artifact-dir artifacts --out-dir runs/port \\
      --epochs 2 --batch-size 8 --device cuda
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..train.trainer import UNet2DArgs, UNet2DTrainer

# UNet2DArgs fields the launcher forwards verbatim (flag name == field name,
# dashes for underscores)
_FORWARDED_TRAIN_FIELDS = (
    "epochs", "batch_size", "workers", "lr", "weight_decay", "loss",
    "model", "encoder", "encoder_weights", "aug", "imagenet_norm", "k",
    "classes", "logger", "save_val_probs", "max_grad_norm", "amp", "seed",
    "data_parallel", "store_dtype", "resume", "save_resume_every",
    "save_resume_steps", "resume_keep",
    "profile_epochs", "store_sharded", "remat", "accum_steps",
    "ckpt_backend", "ckpt_async", "preempt_save",
)

# Flag bundles applied under explicit flags. "tuned-v5e" is the JAX
# package's large-batch bundle (batch 128, lr 1e-3 * sqrt(128 / 8)).
_PRESETS = {
    "tuned-v5e": {"batch_size": 128, "lr": 4e-3},
}


def _split_ratio(value: str) -> float:
    try:
        ratio = float(value)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(
            "split-ratio must be a float") from exc
    if not 0.0 < ratio < 1.0:
        raise argparse.ArgumentTypeError("split-ratio must be within (0, 1)")
    return ratio


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def collect_npz(artifact_dir: Path) -> List[Path]:
    """Every volume.npz under the artifact tree, sorted (the base order the
    seeded shuffle permutes)."""
    return sorted(p for p in artifact_dir.rglob("volume.npz") if p.is_file())


def split_volumes(npz_files: Sequence[Path], ratio: float, seed: int
                  ) -> Tuple[List[Path], List[Path]]:
    """Seed-shuffled copy of the list, cut at round(n * ratio) clamped so
    train and val each keep a volume (a single volume goes to train)."""
    shuffled = list(npz_files)
    random.Random(seed).shuffle(shuffled)
    n = len(shuffled)
    if n <= 1:
        return shuffled, []
    cutoff = min(max(int(round(n * ratio)), 1), n - 1)
    return shuffled[:cutoff], shuffled[cutoff:]


def generate_split(artifact_dir: Path, list_dir: Path, ratio: float,
                   seed: int) -> Tuple[Path, Path]:
    """Write ``list_dir/{train,val}.txt``, one volume.npz path per line."""
    npz_files = collect_npz(artifact_dir)
    if not npz_files:
        raise RuntimeError(
            f"no volume.npz packs under {artifact_dir} — nothing to split; "
            "run the preprocess stage first")
    train_files, val_files = split_volumes(npz_files, ratio, seed)
    list_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for name, files in (("train", train_files), ("val", val_files)):
        path = list_dir / f"{name}.txt"
        path.write_text("\n".join(str(p) for p in files), encoding="utf-8")
        print(f"[launcher] {name} list: {len(files)} volume(s) -> {path}")
        out.append(path)
    return out[0], out[1]


def build_trainer(train_list: Path, val_list: Path, out_dir: Path,
                  args: argparse.Namespace) -> UNet2DTrainer:
    """The trainer of the parsed flags on ``args.device``, not yet run: a
    caller may hold it, e.g. to ``request_preempt()`` it."""
    fields = {name: getattr(args, name) for name in _FORWARDED_TRAIN_FIELDS}
    return UNet2DTrainer(UNet2DArgs(
        train_list=str(train_list), val_list=str(val_list),
        out_dir=str(out_dir), **fields), device=args.device)


def run_training(train_list: Path, val_list: Path, out_dir: Path,
                 args: argparse.Namespace) -> dict:
    """Build the trainer of the parsed flags and train."""
    return build_trainer(train_list, val_list, out_dir, args).run()


# ---------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Preprocess fastMRI volumes and launch U-Net training "
                    "(PyTorch port).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        allow_abbrev=False,
    )
    env_root = os.getenv("FASTMRI_ROOT")
    paths = parser.add_argument_group("paths & stage gates")
    paths.add_argument("--dataset-root", type=Path,
                       default=Path(env_root) if env_root else None,
                       help="Raw fastMRI single-coil dataset root (default "
                            "$FASTMRI_ROOT).")
    paths.add_argument("--artifact-dir", type=Path,
                       default=Path("artifacts") / "fastmri_knee")
    paths.add_argument("--list-dir", type=Path, default=Path("lists"))
    paths.add_argument("--out-dir", type=Path,
                       default=Path("runs") / "fastmri_unet")
    paths.add_argument("--skip-preprocess", action="store_true")
    paths.add_argument("--skip-split", action="store_true")
    paths.add_argument("--skip-train", action="store_true")
    paths.add_argument("--train-list", type=Path,
                       help="Existing train list (overrides the generated "
                            "one).")
    paths.add_argument("--val-list", type=Path,
                       help="Existing val list (overrides the generated "
                            "one).")

    prep = parser.add_argument_group("preprocess")
    prep.add_argument("--height", type=int, default=320)
    prep.add_argument("--width", type=int, default=320)
    prep.add_argument("--slice-keep", default="0.3,0.7",
                      help="Kept slice band as 'lo,hi' fractions.")
    prep.add_argument("--clip", default="1.0,99.5",
                      help="Intensity clip percentiles as 'lo,hi'.")
    prep.add_argument("--preview-max", type=int, default=6)
    prep.add_argument("--skip-existing", action="store_true",
                      help="Skip volumes whose pack is complete.")
    prep.add_argument("--use-n4", action="store_true")
    prep.add_argument("--use-denoise", action="store_true")
    prep.add_argument("--split-ratio", type=_split_ratio, default=0.8)
    prep.add_argument("--split-seed", type=int, default=42)

    train = parser.add_argument_group("training")
    train.add_argument("--device", default="cuda",
                       help="cuda or cpu; cuda raises without a card.")
    train.add_argument("--preset", choices=sorted(_PRESETS), default=None,
                       help="flag bundle (tuned-v5e: batch 128, lr 4e-3); "
                            "explicit flags win")
    train.add_argument("--epochs", type=int, default=20)
    train.add_argument("--batch-size", type=int, default=8)
    train.add_argument("--workers", type=int, default=4)
    train.add_argument("--lr", type=float, default=1e-3)
    train.add_argument("--weight-decay", type=float, default=1e-4)
    train.add_argument("--loss", default="dice_bce",
                       choices=["dice_bce", "focal", "tversky",
                                "focal_tversky", "dice_ce", "ce"])
    train.add_argument("--model", default="unet", choices=["unet", "unetpp"])
    train.add_argument("--encoder", default="resnet34")
    train.add_argument("--encoder-weights", default="none")
    train.add_argument("--aug", default="light",
                       choices=["none", "light", "medium", "heavy"])
    train.add_argument("--imagenet-norm", action="store_true")
    train.add_argument("--k", type=int, default=1)
    train.add_argument("--classes", type=int, default=1)
    train.add_argument("--logger", default="csv",
                       choices=["noop", "csv", "tb", "csv+tb"])
    train.add_argument("--save-val-probs", action="store_true")
    train.add_argument("--max-grad-norm", type=float, default=5.0)
    train.add_argument("--seed", type=int, default=2024)
    train.add_argument("--no-amp", dest="amp", action="store_false",
                       help="Compute in f32 (no bf16 autocast).")
    train.add_argument("--amp", dest="amp", action="store_true")
    parser.set_defaults(amp=True)

    ext = parser.add_argument_group(
        "JAX package extensions (the trainer refuses those not ported)")
    ext.add_argument("--data-parallel", type=int, default=1)
    ext.add_argument("--store-dtype", default="float32",
                     choices=["float32", "bfloat16"],
                     help="Device slice-store dtype.")
    ext.add_argument("--resume", action="store_true")
    ext.add_argument("--save-resume-every", type=int, default=0)
    ext.add_argument("--save-resume-steps", type=int, default=0)
    ext.add_argument("--resume-keep", type=int, default=0)
    ext.add_argument("--ckpt-backend", default="msgpack",
                     choices=["msgpack", "orbax"])
    ext.add_argument("--ckpt-async", action="store_true")
    ext.add_argument("--preempt-save", action="store_true")
    ext.add_argument("--store-sharded", action="store_true")
    ext.add_argument("--profile-epochs", type=int, default=0)
    ext.add_argument("--remat", action="store_true")
    ext.add_argument("--accum-steps", type=int, default=1,
                     help="Microbatches per optimizer update.")
    return parser


def apply_preset(parser: argparse.ArgumentParser, ns: argparse.Namespace,
                 argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """Overlay ``ns`` with the preset's values, except where the flag was
    given explicitly."""
    if not getattr(ns, "preset", None):
        return ns
    values = _PRESETS[ns.preset]
    given = list(argv if argv is not None else sys.argv[1:])
    explicit = {a.dest for a in parser._actions
                if a.option_strings and any(
                    g == s or g.startswith(s + "=")
                    for g in given for s in a.option_strings)}
    for dest, value in values.items():
        if dest not in explicit:
            setattr(ns, dest, value)
    print(f"[launcher] preset {ns.preset}: " + ", ".join(
        f"{k}={getattr(ns, k)}" for k in values))
    return ns


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    ns = apply_preset(parser, parser.parse_args(argv), argv)

    artifact_dir = Path(ns.artifact_dir).resolve()
    list_dir = Path(ns.list_dir).resolve()
    out_dir = Path(ns.out_dir).resolve()

    if ns.skip_preprocess:
        print("[launcher] stage skipped: preprocess")
    else:
        parser.error(
            "the preprocess stage reads fastMRI .h5 files, and the .h5 "
            "adapters (data/adapters.py) are not ported yet; make packs with "
            "data/packer.py:pack_kspace_volume and pass --skip-preprocess")

    made_train = made_val = None
    if ns.skip_split:
        print("[launcher] stage skipped: split")
    else:
        made_train, made_val = generate_split(
            artifact_dir, list_dir, ns.split_ratio, ns.split_seed)

    train_list = (Path(ns.train_list).resolve() if ns.train_list
                  else made_train or list_dir / "train.txt")
    val_list = (Path(ns.val_list).resolve() if ns.val_list
                else made_val or list_dir / "val.txt")
    for label, path in (("train", train_list), ("val", val_list)):
        if not path.exists():
            parser.error(f"{label} list does not exist: {path}")

    if ns.skip_train:
        print("[launcher] stage skipped: train")
        return 0

    print(f"[launcher] training -> {out_dir}")
    run_training(train_list, val_list, out_dir, ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
