"""Sequence of samples over an adapter and an optional preprocessor.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/trainer_dataset.py``,
the same class and contract: discovery runs once at construction, records
load lazily per index, an optional preprocessor (an object with
``preprocess_record`` or a plain callable) transforms each, and the
adapter's and the descriptor's metadata are merged into each sample. With
the port's :class:`~.preprocess.MRIKneePreprocessor` the sample's arrays
are tensors on the preprocessor's device.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Dict, List, Optional

from .adapters import BaseAdapter


def _call_discover(adapter: BaseAdapter, root: Optional[str]) -> List[Any]:
    """``discover_records`` with or without a root, for adapters whose
    signature takes none."""
    if root is not None:
        try:
            found = adapter.discover_records(root)
        except TypeError:
            found = adapter.discover_records()
    else:
        found = adapter.discover_records()
    return found if isinstance(found, list) else list(found)


class TrainerDataset(Sequence):
    """Adapter-backed sample sequence with optional preprocessing."""

    def __init__(self, adapter: BaseAdapter, *,
                 root_dir: Optional[str] = None,
                 preprocessor: Any = None) -> None:
        self.adapter = adapter
        self.preprocessor = preprocessor
        self.root_dir = root_dir or getattr(adapter, "root_dir", None)
        self._records = _call_discover(adapter, self.root_dir)

    def __len__(self) -> int:
        return len(self._records)

    def _merged_meta(self, record: Dict[str, Any], descriptor: Any,
                     index: int) -> Dict[str, Any]:
        meta = dict(record.get("meta", {}))
        if isinstance(descriptor, dict):
            for key in ("filepath", "slice_idx"):
                if key in descriptor:
                    meta.setdefault(key, descriptor[key])
        meta.setdefault("adapter", type(self.adapter).__name__)
        meta.setdefault("index", index)
        return meta

    @staticmethod
    def _raw_sample(record: Dict[str, Any]) -> Dict[str, Any]:
        image = record.get("image")
        if image is None:
            image = record.get("target")
        return {"image": image, "mask": record.get("mask"),
                "label": record.get("label"),
                "source": record.get("source", "raw")}

    def _processed_sample(self, record: Dict[str, Any],
                          meta: Dict[str, Any]) -> Dict[str, Any]:
        pre = self.preprocessor
        if hasattr(pre, "preprocess_record"):
            processed = pre.preprocess_record(record)
        elif callable(pre):
            processed = pre(record)
        else:
            raise TypeError("Preprocessor must be callable or expose "
                            "preprocess_record(record)")
        sample = {"image": processed.get("img_z"),
                  "mask": processed.get("mask"),
                  "preview": processed.get("img_01"),
                  "source": processed.get("source")}
        if "tensor" in processed:
            sample["tensor"] = processed["tensor"]
        proc_meta = processed.get("meta")
        if proc_meta is not None:
            merged = dict(proc_meta)
            merged.update({k: v for k, v in meta.items() if k not in merged})
            sample["meta"] = merged
        if record.get("label") is not None:
            sample.setdefault("label", record["label"])
        return sample

    def __getitem__(self, index: int) -> Dict[str, Any]:
        descriptor = self._records[index]
        record = self.adapter.load_record(descriptor)
        meta = self._merged_meta(record, descriptor, index)
        sample = (self._raw_sample(record) if self.preprocessor is None
                  else self._processed_sample(record, meta))
        sample.setdefault("meta", meta)
        return sample
