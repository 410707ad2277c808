"""Raw-data adapters (host-side I/O).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/adapters.py``, the
same classes, records and contract:

- ``BaseAdapter``: ``discover_records`` and ``load_record``.
- ``FastMRISinglecoilAdapter``: fastMRI single-coil ``.h5`` files, one
  record a slice (``{filepath, slice_idx}``), the k-space and the first of
  ``reconstruction_rss`` / ``_esc`` / ``reconstruction`` as the target,
  the root from the argument or ``$FASTMRI_ROOT``; ``load_volume`` reads a
  whole file in one pass and gives its k-space as a float32 ``(S, H, W,
  2)`` pair. Its reads go through ``native.load_h5_slab``, and it needs
  h5py: without it every method raises an ImportError that names h5py.
- ``KneePckAdapter``: pickled classification volumes (``.pck`` /
  ``.pickle``), dict-of-arrays or list-of-pairs layouts, an image and an
  optional int label a record. It needs no h5py.
"""

from __future__ import annotations

import glob
import os
import pickle
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

from ..native import import_h5py, load_h5_slab
from ..ops.fftc import to_pair_np


class BaseAdapter(ABC):
    """Abstract base class for dataset adapters."""

    def __init__(self, root_dir: Optional[str] = None) -> None:
        self.root_dir = root_dir

    @abstractmethod
    def discover_records(self, root_dir: Optional[str] = None) -> List[Any]:
        """Lightweight descriptors of each record to be processed."""

    @abstractmethod
    def load_record(self, record: Any) -> Any:
        """One record, given a descriptor from ``discover_records``."""


class FastMRISinglecoilAdapter(BaseAdapter):
    """fastMRI single-coil ``.h5`` volumes: per-slice records and a bulk
    volume load."""

    TARGET_KEYS = ("reconstruction_rss", "reconstruction_esc",
                   "reconstruction")

    def __init__(self, root_dir: Optional[str] = None,
                 env_key: str = "FASTMRI_ROOT"):
        resolved = root_dir or os.getenv(env_key)
        if not resolved:
            raise ValueError(f"Must provide root_dir or set env {env_key}")
        super().__init__(resolved)

    def _target_key(self, h5py, filepath: str):
        """``(slices, target key or None)`` of one file."""
        with h5py.File(filepath, "r") as hf:
            return (hf["kspace"].shape[0],
                    next((c for c in self.TARGET_KEYS if c in hf), None))

    def discover_records(self, root_dir: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
        h5py = import_h5py("discovering fastMRI .h5 records")
        root = root_dir or self.root_dir
        if not root:
            raise ValueError("Missing root directory for fastMRI adapter")
        records = []
        for fp in sorted(glob.glob(os.path.join(root, "*.h5"))):
            with h5py.File(fp, "r") as hf:
                num_slices = hf["kspace"].shape[0]
            records.extend({"filepath": fp, "slice_idx": s}
                           for s in range(num_slices))
        return records

    def load_record(self, record: Dict[str, Any]) -> Dict[str, Any]:
        h5py = import_h5py("loading a fastMRI .h5 record")
        fp, s = record["filepath"], record["slice_idx"]
        _, target_key = self._target_key(h5py, fp)
        kspace = load_h5_slab(fp, "kspace", [s], axis=0)[0]
        target = (load_h5_slab(fp, target_key, [s], axis=0)[0]
                  if target_key else None)
        return {
            "image": None, "mask": None, "label": None,
            "kspace": kspace, "target": target,
            "meta": {"filepath": fp, "slice_idx": s, "dataset": "fastmri",
                     "target_key": target_key,
                     "adapter": "fastmri_singlecoil-h5"},
        }

    def load_volume(self, filepath: str) -> Dict[str, Any]:
        """The whole volume in one pass: ``{"kspace_pair": (S, H, W, 2) f32,
        "target": (S, Ht, Wt) f32 or None, "metas": [one dict a slice]}``,
        in place of a reopen of the file for each slice."""
        h5py = import_h5py("loading a fastMRI .h5 volume")
        n, target_key = self._target_key(h5py, filepath)
        kspace = load_h5_slab(filepath, "kspace", range(n), axis=0)
        target = (load_h5_slab(filepath, target_key, range(n), axis=0)
                  .astype(np.float32) if target_key else None)
        metas = [{"filepath": filepath, "slice_idx": s, "dataset": "fastmri",
                  "target_key": target_key,
                  "adapter": "fastmri_singlecoil-h5"}
                 for s in range(kspace.shape[0])]
        return {"kspace_pair": to_pair_np(kspace), "target": target,
                "metas": metas}


def _coerce_img(x) -> np.ndarray:
    """An image as a numpy array: a PIL image or any array-like goes
    through ``np.array``, so PIL stays optional (nothing here imports
    it)."""
    return x if isinstance(x, np.ndarray) else np.array(x)


class KneePckAdapter(BaseAdapter):
    """Pickled classification dataset (``.pck`` / ``.pickle``): images and
    optional labels."""

    IMG_KEYS = ("data", "images", "x", "X")
    LABEL_KEYS = ("labels", "y", "Y", "target", "targets")

    def __init__(self, pck_pattern=("*.pck", "*.pickle")):
        super().__init__(None)
        self.pck_pattern = pck_pattern

    def _list_pck_files(self, root_dir: str) -> List[str]:
        files: List[str] = []
        for pat in self.pck_pattern:
            files += glob.glob(os.path.join(root_dir, "**", pat),
                               recursive=True)
        return sorted(set(files))

    def _probe_length(self, pck_path: str) -> int:
        with open(pck_path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, dict):
            for key in self.IMG_KEYS + self.LABEL_KEYS:
                if key in obj:
                    return len(obj[key])
            for v in obj.values():
                if isinstance(v, (list, tuple, np.ndarray)):
                    return len(v)
            raise ValueError(f"Unrecognized dict layout in {pck_path}")
        if isinstance(obj, (list, tuple)):
            return len(obj)
        raise ValueError(f"Unsupported pickle root type: {type(obj)} in "
                         f"{pck_path}")

    def discover_records(self, root_dir: str) -> List[Dict[str, Any]]:
        records = []
        for pck in self._list_pck_files(root_dir):
            n = self._probe_length(pck)
            records.extend({"pck_path": pck, "item_idx": i}
                           for i in range(n))
        return records

    def _read_item(self, pck_path: str, idx: int):
        with open(pck_path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, dict):
            key = next((k for k in self.IMG_KEYS if k in obj), None)
            if key is None:
                arr_keys = [k for k, v in obj.items()
                            if isinstance(v, (list, tuple, np.ndarray))]
                if not arr_keys:
                    raise ValueError(
                        f"No array-like found in dict of {pck_path}")
                key = arr_keys[0]
            img = _coerce_img(obj[key][idx])
            label = next((int(obj[lk][idx]) for lk in self.LABEL_KEYS
                          if lk in obj), None)
            return img, label
        if isinstance(obj, (list, tuple)):
            item = obj[idx]
            if isinstance(item, (list, tuple)) and len(item) >= 2:
                return (_coerce_img(item[0]),
                        int(item[1]) if item[1] is not None else None)
            return _coerce_img(item), None
        raise ValueError(
            f"Unsupported pickle root type while read: {type(obj)}")

    def load_record(self, record: Dict[str, Any]) -> Dict[str, Any]:
        pck_path, idx = record["pck_path"], record["item_idx"]
        img, label = self._read_item(pck_path, idx)
        return {"image": img, "mask": None, "label": label,
                "meta": {"filepath": pck_path, "item_idx": idx,
                         "dataset": "kaggle-knee"}}
