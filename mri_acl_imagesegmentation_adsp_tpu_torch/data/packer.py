"""Preprocessed-volume packs: the training input on disk.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/packer.py``:
``save_pack`` (:39-99) with the same files and QC statistics,

  tensor.pt              (S, 1, H, W) float32 torch tensor
  volume.npz             {img: (S, 1, H, W) f32, msk: (S, H, W) u8}
  mask.npy               (S, H, W) uint8
  indices.json, metas.json
  preview/slice_XXX.png  the first ``preview_max`` preview slices
  stats.json             in-mask mean / std of each z-scored slice

and the corpus drivers ``group_records_by_file`` and ``build_preprocess``
(:25-36, :102-216): every volume an adapter discovers, read on a prefetch
thread, preprocessed on the preprocessor's device and written on one writer
thread. ``pack_kspace_volume`` is ``build_preprocess``'s per-volume step for
a volume already in memory.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from ..utils.png import write_png
from .adapters import BaseAdapter, FastMRISinglecoilAdapter
from .prefetch import Prefetcher
from .preprocess import MRIKneePreprocessor


def group_records_by_file(records: List[Dict]) -> Dict[str, List[Dict]]:
    """Per-slice records grouped by file, each group sorted by slice.

    A record names its file by ``filepath`` (the ``.h5`` adapter) or
    ``pck_path`` (``KneePckAdapter``), and its place by ``slice_idx`` or
    ``item_idx``. The JAX version reads only ``filepath`` and
    ``slice_idx``, so its ``build_preprocess`` fails on the pickle
    adapter's records with a KeyError; the port packs them a file a
    volume."""
    buckets: Dict[str, List[Dict]] = {}
    for r in records:
        buckets.setdefault(r.get("filepath", r.get("pck_path")),
                           []).append(r)
    for fp in buckets:
        buckets[fp] = sorted(buckets[fp], key=lambda x: x.get(
            "slice_idx", x.get("item_idx")))
    return buckets


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def save_pack(out_dir: str, pack: Dict[str, Any],
              preview_max: int = 8) -> None:
    """Write one preprocessed volume: ``pack`` has ``tensor`` (S, 1, H, W),
    ``mask`` (S, H, W) and ``preview`` (S, H, W) as arrays or tensors on any
    device, and optionally ``indices`` and ``metas``. ``stats.json`` is
    written last, so its presence marks a complete pack."""
    os.makedirs(out_dir, exist_ok=True)
    tensor = np.asarray(_host(pack["tensor"]), dtype=np.float32)
    mask = np.asarray(_host(pack["mask"]), dtype=np.uint8)

    torch.save(torch.from_numpy(tensor.copy()),
               os.path.join(out_dir, "tensor.pt"))
    np.savez_compressed(os.path.join(out_dir, "volume.npz"),
                        img=tensor, msk=mask)
    np.save(os.path.join(out_dir, "mask.npy"), mask)
    indices = list(pack.get("indices", []))
    for name, value in (("indices", indices),
                        ("metas", pack.get("metas", []))):
        with open(os.path.join(out_dir, f"{name}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(value, f, ensure_ascii=False, indent=2)

    prev = np.asarray(_host(pack["preview"]))
    pv_dir = os.path.join(out_dir, "preview")
    os.makedirs(pv_dir, exist_ok=True)
    for i in range(min(preview_max, prev.shape[0])):
        # a short or missing "indices" numbers the previews by position
        sid = indices[i] if i < len(indices) else i
        write_png(os.path.join(pv_dir, f"slice_{sid:03d}.png"),
                  np.clip(prev[i] * 255.0, 0, 255).astype(np.uint8))

    img_z = tensor[:, 0]
    means, stds = [], []
    for s in range(img_z.shape[0]):
        vals = img_z[s][mask[s] > 0]
        if vals.size == 0:
            means.append(float("nan"))
            stds.append(float("nan"))
        else:
            means.append(float(vals.mean()))
            stds.append(float(vals.std()))
    stats = {
        "count_slices": int(tensor.shape[0]),
        "mean_in_mask_mean": (float(np.nanmean(means)) if means
                              else float("nan")),
        "mean_in_mask_std": float(np.nanmean(stds)) if stds else float("nan"),
        "per_slice_mean": means[:50],
        "per_slice_std": stds[:50],
    }
    with open(os.path.join(out_dir, "stats.json"), "w",
              encoding="utf-8") as f:
        json.dump(stats, f, ensure_ascii=False, indent=2)


def pack_kspace_volume(preprocessor: MRIKneePreprocessor, kspace_pair,
                       out_dir: str, preview_max: int = 8,
                       target=None) -> Dict[str, Any]:
    """Preprocess one single-coil ``(S, H, W, 2)`` or multi-coil ``(S, C,
    H, W, 2)`` k-space volume on the preprocessor's device, with its
    settings, and save its pack in ``out_dir``; with ``target``, an ``(S,
    H, W)`` reconstruction of the volume, that is preprocessed instead
    (``kspace_pair`` may then be None). Returns the summary entry
    ``build_preprocess`` gives a volume."""
    pack = (preprocessor.preprocess_volume_images(target, source="target")
            if target is not None
            else preprocessor.preprocess_volume_pairs(kspace_pair))
    save_pack(out_dir, pack, preview_max=preview_max)
    return {"output_dir": str(out_dir),
            "npz_path": os.path.join(str(out_dir), "volume.npz"),
            "num_slices": int(pack["tensor"].shape[0])}


def _skip_existing(grouped, out_root: Path):
    """``(summary of the complete packs, the groups still to do)``: a pack
    is complete once its ``stats.json``, written last, exists, so a pack
    an interrupted run left half-written is redone."""
    done, remaining = [], []
    for filepath, record_defs in grouped:
        d = out_root / Path(filepath).stem
        if (d / "volume.npz").is_file() and (d / "stats.json").is_file():
            with open(d / "stats.json", encoding="utf-8") as f:
                n = int(json.load(f).get("count_slices", 0))
            done.append({"filepath": filepath, "output_dir": str(d),
                         "npz_path": str(d / "volume.npz"),
                         "num_slices": n, "skipped_existing": True})
        else:
            remaining.append((filepath, record_defs))
    if done:
        print(f"[preprocess] skip-existing: {len(done)} of {len(grouped)} "
              "volumes already packed")
    return done, remaining


def build_preprocess(args, adapter: BaseAdapter) -> List[Dict[str, Any]]:
    """Preprocess every volume the adapter discovers into packs under
    ``args.out_dir``; returns one summary entry a volume.

    ``args`` needs ``root_dir``, ``out_dir``, ``height``, ``width``,
    ``slice_keep`` ("lo,hi"), ``clip`` ("lo,hi"), ``use_n4``,
    ``use_denoise`` and ``preview_max``; ``skip_existing`` and ``device``
    (default ``cuda``, which raises without a card) are optional.

    A ``FastMRISinglecoilAdapter`` volume is read in one ``.h5`` pass and
    preprocessed as one stack: its target when the file has one (the
    reference's record priority image -> target -> k-space), else its
    k-space. Other adapters' records go through ``preprocess_records`` a
    file at a time. The next volume is read on a prefetch thread, and each
    pack is written on one writer thread with at most two packs in flight,
    so host I/O overlaps the device; the artifacts are the sequential
    loop's, since the per-volume calls and their order are the same."""
    preprocessor = MRIKneePreprocessor(
        out_size=(args.height, args.width),
        slice_keep=_parse_pair(args.slice_keep, "slice_keep"),
        clip_percentiles=_parse_pair(args.clip, "clip"),
        use_n4=args.use_n4, use_denoise=args.use_denoise,
        device=getattr(args, "device", "cuda"))
    out_root = Path(args.out_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    try:
        records = adapter.discover_records(args.root_dir)
    except TypeError:
        records = adapter.discover_records()
    if not records:
        return []
    grouped = list(group_records_by_file(records).items())
    skipped = []
    if getattr(args, "skip_existing", False):
        skipped, grouped = _skip_existing(grouped, out_root)
        if not grouped:
            return skipped
    bulk = isinstance(adapter, FastMRISinglecoilAdapter)

    class _Loads:
        """Indexable volume loads for the prefetch thread."""

        def __len__(self):
            return len(grouped)

        def __getitem__(self, i):
            filepath, record_defs = grouped[i]
            if bulk:
                return filepath, adapter.load_volume(filepath)
            return filepath, [adapter.load_record(r) for r in record_defs]

    summary = []
    writes: List = []
    with ThreadPoolExecutor(max_workers=1) as writer:
        for filepath, loaded in Prefetcher(_Loads(), depth=2, workers=1):
            if len(writes) >= 2:
                # backpressure: at most two packs in flight, and a failed
                # write (a full disk) surfaces now, not at the corpus' end
                writes.pop(0).result()
            if not bulk:
                pack = preprocessor.preprocess_records(loaded)
            elif loaded["target"] is not None:
                pack = preprocessor.preprocess_volume_images(
                    loaded["target"], loaded["metas"], source="target")
            else:
                pack = preprocessor.preprocess_volume_pairs(
                    loaded["kspace_pair"], loaded["metas"])
            out_dir = out_root / Path(filepath).stem
            writes.append(writer.submit(save_pack, str(out_dir), pack,
                                        preview_max=args.preview_max))
            summary.append({"filepath": filepath,
                            "output_dir": str(out_dir),
                            "npz_path": str(out_dir / "volume.npz"),
                            "num_slices": int(pack["tensor"].shape[0])})
        for w in writes:
            w.result()
    return skipped + summary


def _parse_pair(value, name: str):
    """``(lo, hi)`` floats from a pair or a "lo,hi" string."""
    if isinstance(value, (tuple, list)):
        return float(value[0]), float(value[1])
    parts = [p.strip() for p in str(value).split(",") if p.strip()]
    if len(parts) != 2:
        raise ValueError(f"{name} must look like 'lo,hi'")
    return float(parts[0]), float(parts[1])
