"""Preprocessed-volume packs: the training input on disk.

Counterpart: ``save_pack`` in
``mri_acl_imagesegmentation_adsp_tpu/data/packer.py:39-99``, with the same
files and QC statistics:

  tensor.pt              (S, 1, H, W) float32 torch tensor
  volume.npz             {img: (S, 1, H, W) f32, msk: (S, H, W) u8}
  mask.npy               (S, H, W) uint8
  indices.json, metas.json
  preview/slice_XXX.png  the first ``preview_max`` preview slices
  stats.json             in-mask mean / std of each z-scored slice

``pack_kspace_volume`` is ``build_preprocess``'s per-volume step
(:102-216) for a volume already in memory, single-coil or multi-coil, with
the preprocessor's own settings (N4 and NL-means among them): the volume's
reconstruction ``target`` when it has one, which outranks the k-space as
in the reference's record priority, else its k-space. Reading fastMRI
``.h5`` files (``data/adapters.py``) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..utils.png import write_png
from .preprocess import MRIKneePreprocessor


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
