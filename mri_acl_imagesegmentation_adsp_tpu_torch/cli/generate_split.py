"""Standalone train/val split of the ``volume.npz`` packs.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/generate_split.py:
20-58``: every ``volume.npz`` under an artifact directory goes to
``all.txt``; a seeded shuffle (default seed 42) cut at ``ratio`` writes
``<output-dir>/train.txt`` and ``val.txt``, one path per line.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.generate_split \\
      --artifact-dir artifacts/fastmri_knee [--output-dir lists] \\
      [--ratio 0.8] [--seed 42] [--all-file all.txt]
"""

from __future__ import annotations

import argparse
import pathlib
import random


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Generate train/val split lists",
                                allow_abbrev=False)
    p.add_argument("--artifact-dir", type=pathlib.Path, required=True)
    p.add_argument("--output-dir", type=pathlib.Path,
                   default=pathlib.Path("lists"))
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--all-file", type=pathlib.Path,
                   default=pathlib.Path("all.txt"))
    args = p.parse_args(argv)

    print("[1/3] Scanning for volume.npz files...")
    npz_files = list(args.artifact_dir.rglob("volume.npz"))
    print(f"  -> Found {len(npz_files)} files")
    if not npz_files:
        print("[ERROR] No volume.npz found. Run preprocess step first.")
        return 1

    args.all_file.write_text("\n".join(str(f) for f in npz_files),
                             encoding="utf-8")

    print(f"[2/3] Splitting {args.ratio:.0%} into train/val...")
    paths = [str(f) for f in npz_files]
    # random.seed + random.shuffle in the reference; the same stream
    random.Random(args.seed).shuffle(paths)
    k = int(len(paths) * args.ratio)

    args.output_dir.mkdir(exist_ok=True, parents=True)
    (args.output_dir / "train.txt").write_text("\n".join(paths[:k]),
                                               encoding="utf-8")
    (args.output_dir / "val.txt").write_text("\n".join(paths[k:]),
                                             encoding="utf-8")
    print(f"[OK] Train: {k} files | Val: {len(paths) - k} files")
    print(f"[3/3] Lists saved in: {args.output_dir.resolve()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
