"""MRI knee preprocessing chain, batched over the slices of a volume.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/preprocess.py``
``MRIKneePreprocessor``: the slice chain (:78-122) with its multi-coil
branch (:90-96) and the optional N4 and NL-means steps (:110-113),
``ifft2c_single``, ``preprocess_record(s)``, ``preprocess_volume_pairs``,
``preprocess_volumes_pairs``, ``preprocess_volume_images`` and their helpers
(:194-436), and the module-level shims (:443-486).

The JAX version jits one slice and vmaps it; here every step takes the whole
``(S, H, W)`` stack, and every result is a tensor on the preprocessor's
device. The JAX version's fixed connected-component sweeps and its fallback
for slices they do not settle have no counterpart: the port's connected
components always run to the fixpoint (``ops/kernels/components.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.fftc import (as_complex, ifft2c, ifft2c_magnitude, rss_complex,
                        to_pair_np)
from ..ops.imageops import (clip_sorted, preview_01, resize_bilinear,
                            zscore_in_mask)
from ..ops.maskops import body_mask
from ..ops.restoration import n4_bias_correction, nl_means_denoise
from ..utils.device import resolve_device


class MRIKneePreprocessor:
    """Knee-MRI preprocessor (the reference's surface): single-coil or
    multi-coil k-space, or images, through the chain."""

    def __init__(
        self,
        out_size: Tuple[int, int] = (320, 320),
        slice_keep: Tuple[float, float] = (0.3, 0.7),
        clip_percentiles: Tuple[float, float] = (1.0, 99.5),
        use_n4: bool = False,
        use_denoise: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.out_size = tuple(int(v) for v in out_size)
        self.slice_keep = tuple(float(v) for v in slice_keep)
        self.clip_percentiles = tuple(float(v) for v in clip_percentiles)
        self.use_n4 = bool(use_n4)
        self.use_denoise = bool(use_denoise)
        lo, hi = self.slice_keep
        if not (0.0 <= lo < hi <= 1.0):
            raise ValueError("slice_keep must satisfy 0.0 <= lo < hi <= 1.0")
        pmin, pmax = self.clip_percentiles
        if not (0.0 <= pmin < pmax <= 100.0):
            raise ValueError(
                "clip_percentiles must be in [0,100] with pmin < pmax")
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # The chain
    # ------------------------------------------------------------------

    def _clip(self, x: torch.Tensor, from_kspace: bool):
        """A stack -> its images clipped to their percentiles, and each
        slice's clipped values sorted, at the input resolution, on ``x``'s
        device. ``x`` is ``(S, H, W, 2)`` single-coil or ``(S, C, H, W, 2)``
        multi-coil k-space pairs (any float dtype; a multi-coil slice is the
        root sum of squares of its coils' iFFTs), or ``(S, H, W)`` images.
        One sort per slice serves both the percentile clip and the Otsu
        histogram, as in the reference."""
        if from_kspace:
            x = x.float()
            if x.dim() == 5:
                img = rss_complex(ifft2c(as_complex(x)), dim=1).float()
            else:
                img = ifft2c_magnitude(x)
        else:
            img = x.float()
        return clip_sorted(img, *self.clip_percentiles)

    def _clip_and_mask(self, x: torch.Tensor, from_kspace: bool):
        """:meth:`_clip`'s images and their body masks."""
        img, srt = self._clip(x, from_kspace)
        return img, body_mask(img, sorted_values=srt)

    def _volume_chain(self, x: torch.Tensor, from_kspace: bool):
        """A stack, as :meth:`_clip` takes it, -> ``(img_z, img_01, mask)``
        at ``out_size``. N4 and NL-means, when on, run after the body mask
        and before the resize."""
        img, mk = self._clip_and_mask(x, from_kspace)
        if self.use_n4:
            img = n4_bias_correction(img, mk)
        if self.use_denoise:
            img = nl_means_denoise(img)
        img_r = resize_bilinear(img, self.out_size)
        mk_r = (resize_bilinear(mk.float(), self.out_size) > 0.5
                ).to(torch.uint8)
        return zscore_in_mask(img_r, mk_r), preview_01(img_r, mk_r), mk_r

    def _pack(self, stack: torch.Tensor, from_kspace: bool, source: str,
              metas: Optional[List[dict]]) -> Dict[str, Any]:
        """The keep band of a stack through the chain, as the bulk paths
        return it."""
        s0, s1 = self._keep_band(stack.shape[0])
        img_z, img_01, mk = self._volume_chain(stack[s0:s1], from_kspace)
        metas = metas[s0:s1] if metas else [{} for _ in range(s1 - s0)]
        return {"tensor": img_z[:, None], "preview": img_01, "mask": mk,
                "indices": [m.get("slice_idx", s0 + i)
                            for i, m in enumerate(metas)],
                "sources": [source] * (s1 - s0), "metas": metas}

    def _upload(self, arr) -> torch.Tensor:
        """A numpy array or tensor to this device as float32."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return arr.to(self.device, torch.float32)

    # ------------------------------------------------------------------
    # Public API (the reference's surface)
    # ------------------------------------------------------------------

    @staticmethod
    def ifft2c_single(kspace_2d, device: str | torch.device = "cuda"
                      ) -> np.ndarray:
        """Centered iFFT magnitude of one complex ``(H, W)`` (or ``(C, H,
        W)``) slice or its ``(..., 2)`` pair, computed on ``device`` and
        read back to numpy."""
        MRIKneePreprocessor._ensure_2d(kspace_2d, "kspace")
        pair = torch.from_numpy(MRIKneePreprocessor._pairify(kspace_2d))
        return ifft2c_magnitude(pair.to(resolve_device(device))
                                ).cpu().numpy()

    def preprocess_record(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """One adapter record -> ``{img_z (H, W), img_01 (H, W), mask (H, W)
        uint8, meta, source}``, the arrays as tensors on this device."""
        x, src, meta = self._normalize_record_input(record)
        if src == "kspace":
            stack = self._upload(self._pairify(x)[None])
        else:
            stack = self._upload(np.asarray(x, np.float32)[None])
        img_z, img_01, mk = self._volume_chain(stack, src == "kspace")
        return {"img_z": img_z[0], "img_01": img_01[0], "mask": mk[0],
                "meta": meta, "source": src}

    def preprocess_records(self, records: List[Dict[str, Any]]
                           ) -> Dict[str, Any]:
        """A volume's records through the keep band and the chain.

        Returns ``{"tensor": (S, 1, H, W), "preview": (S, H, W), "mask":
        (S, H, W) uint8}`` as tensors on this device, with ``indices``,
        ``sources`` and ``metas``. Kept records of one source and one shape
        run as one stack; otherwise each runs alone."""
        ns = len(records)
        if ns == 0:
            raise ValueError("No records provided to preprocess_records.")
        s0, s1 = self._keep_band(ns)
        kept = records[s0:s1]
        normalized = [self._normalize_record_input(r) for r in kept]
        sources = [src for _, src, _ in normalized]
        metas = [m for _, _, m in normalized]
        idxs = [m.get("slice_idx", s0 + i) for i, m in enumerate(metas)]

        if len(set(sources)) == 1 and len({x.shape for x, _, _ in
                                           normalized}) == 1:
            if sources[0] == "kspace":
                stack = np.stack([self._pairify(x) for x, _, _ in normalized])
            else:
                stack = np.stack([np.asarray(x, np.float32)
                                  for x, _, _ in normalized])
            img_z, img_01, mk = self._volume_chain(
                self._upload(stack), sources[0] == "kspace")
        else:
            outs = [self.preprocess_record(r) for r in kept]
            img_z = torch.stack([o["img_z"] for o in outs])
            img_01 = torch.stack([o["img_01"] for o in outs])
            mk = torch.stack([o["mask"] for o in outs])
        return {"tensor": img_z[:, None], "preview": img_01, "mask": mk,
                "indices": [int(i) for i in idxs], "sources": sources,
                "metas": metas}

    def preprocess_volume_pairs(self, kspace_pair,
                                metas: Optional[List[dict]] = None
                                ) -> Dict[str, Any]:
        """Bulk k-space path: ``(S, H, W, 2)`` single-coil or ``(S, C, H, W,
        2)`` multi-coil float pairs (numpy or torch) through the keep band
        and the chain.

        Returns ``{"tensor": (S', 1, H, W) f32, "preview": (S', H, W) f32,
        "mask": (S', H, W) uint8}`` as tensors on this preprocessor's
        device, with ``indices`` (the kept slices' indices), ``sources`` and
        ``metas``."""
        return self._pack(self._upload(self._kspace_stack(kspace_pair)),
                          True, "kspace", metas)

    def preprocess_volumes_pairs(self, kspace_pairs,
                                 metas_list: Optional[List] = None,
                                 transfer_dtype: Optional[str] = None,
                                 devices: Optional[List] = None
                                 ) -> List[Dict[str, Any]]:
        """Many volumes (each as :meth:`preprocess_volume_pairs` takes it),
        one result each, equal to per-volume calls.

        ``transfer_dtype="bfloat16"`` rounds each pair to bfloat16 on the
        host (round to nearest even), so the upload carries half the bytes,
        and upcasts it on the device: a bandwidth-for-accuracy trade, not
        exact. ``devices``: a list of one device to run on; more than one
        raises, since spreading volumes over cards is not ported."""
        if transfer_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unsupported transfer_dtype {transfer_dtype!r}")
        if devices and len(devices) > 1:
            raise NotImplementedError(
                "preprocess_volumes_pairs over more than one device is not "
                "ported; pass one device or none")
        dev = resolve_device(devices[0]) if devices else self.device
        link = torch.bfloat16 if transfer_dtype == "bfloat16" else (
            torch.float32)
        metas_list = metas_list or [None] * len(kspace_pairs)
        results = []
        for pair, metas in zip(kspace_pairs, metas_list):
            self._kspace_stack(pair)
            host = torch.from_numpy(np.ascontiguousarray(pair, np.float32)
                                    ) if isinstance(pair, np.ndarray) else (
                pair.cpu().float())
            stack = host.to(link).to(dev).float()
            results.append(self._pack(stack, True, "kspace", metas))
        return results

    def preprocess_volume_images(self, images,
                                 metas: Optional[List[dict]] = None,
                                 source: str = "target") -> Dict[str, Any]:
        """Bulk image path: an ``(S, H, W)`` float stack (such as an ``.h5``
        ``reconstruction_*`` target, which outranks k-space in the
        reference's record priority) through the keep band and the chain;
        returns what :meth:`preprocess_volume_pairs` returns."""
        stack = self._upload(images)
        if stack.dim() != 3:
            raise ValueError(f"images must be (S, H, W), got shape "
                             f"{tuple(stack.shape)}")
        return self._pack(stack, False, source, metas)

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _kspace_stack(stack):
        """``stack`` (numpy or torch) if it is a k-space real pair, else
        ValueError."""
        if stack.ndim not in (4, 5) or stack.shape[-1] != 2:
            raise ValueError("kspace must be a single-coil (S, H, W, 2) or "
                             "multi-coil (S, C, H, W, 2) real pair, got "
                             f"shape {tuple(stack.shape)}")
        return stack

    def _keep_band(self, ns: int) -> Tuple[int, int]:
        """[s0, s1) band of kept slices: truncate ns*lo / ns*hi, keep at
        least one slice, take the full volume on a degenerate band."""
        lo, hi = self.slice_keep
        s0 = int(ns * lo)
        s1 = min(max(int(ns * hi), s0 + 1), ns)
        if s0 >= s1:
            s0, s1 = 0, ns
        if s0 >= s1:  # only reachable when ns == 0
            raise ValueError("slice_keep selected no slices")
        return s0, s1

    @staticmethod
    def _to_float32(arr) -> np.ndarray:
        return np.squeeze(arr).astype(np.float32, copy=False)

    @staticmethod
    def _ensure_2d(x, name: str):
        nd = np.ndim(x)
        complex_ok = np.iscomplexobj(x) and nd in (2, 3)      # (H,W)|(C,H,W)
        pair_ok = (not np.iscomplexobj(x)) and nd in (3, 4) \
            and np.shape(x)[-1] == 2                          # pairs
        if not (complex_ok or pair_ok):
            raise ValueError(f"{name} must have shape (H,W) or (C,H,W), "
                             f"got {np.shape(x)}")
        return x

    @staticmethod
    def _pairify(ksp) -> np.ndarray:
        """complex ``(..., H, W)`` or ``(..., H, W, 2)`` pair -> ``(..., H,
        W, 2)`` float32 pair."""
        ksp = np.asarray(ksp)
        if np.iscomplexobj(ksp):
            return to_pair_np(ksp)
        if ksp.ndim >= 1 and ksp.shape[-1] == 2:
            return ksp.astype(np.float32)
        raise ValueError(
            "kspace is not complex. Combine (real, imag) -> complex or a "
            "(H,W,2) pair before preprocessing.")

    # 2-D float sources in adapter-record priority order; every
    # reconstruction_* key carries the "target" source tag
    _FLOAT_SOURCES = (("image", "image"), ("target", "target"),
                      ("reconstruction", "target"),
                      ("reconstruction_rss", "target"),
                      ("reconstruction_esc", "target"))

    @staticmethod
    def _normalize_record_input(record: Dict[str, Any]):
        """Pick the record's input array: image, else any reconstruction
        target, else raw k-space. Returns ``(array, source_tag, meta)``."""
        meta = record.get("meta", {})
        for key, tag in MRIKneePreprocessor._FLOAT_SOURCES:
            value = record.get(key)
            if value is None:
                continue
            arr = MRIKneePreprocessor._to_float32(value)
            if arr.ndim != 2:
                raise ValueError(
                    f"record field {key!r} must be a 2-D slice, "
                    f"got shape {arr.shape}")
            return arr, tag, meta

        ksp = record.get("kspace")
        if ksp is None:
            raise ValueError(
                "record carries none of image / reconstruction target / "
                "kspace — nothing to preprocess")
        ksp = np.squeeze(ksp)
        if not np.iscomplexobj(ksp):
            if ksp.ndim == 3 and ksp.shape[0] == 2:
                raise ValueError(
                    "kspace arrived as a split (2, H, W) real/imag stack; "
                    "combine it to complex (or an (H, W, 2) pair) first")
            if not (ksp.ndim == 3 and ksp.shape[-1] == 2):
                raise ValueError(
                    "kspace must be complex (H, W) or an (H, W, 2) pair")
        MRIKneePreprocessor._ensure_2d(ksp, "kspace")
        return ksp, "kspace", meta


# ---------------------------------------------------------------------------
# Convenience API
# ---------------------------------------------------------------------------

def _resolve_preprocessor(preprocessor=None, **kwargs):
    if preprocessor is None:
        return MRIKneePreprocessor(**kwargs)
    if kwargs:
        raise ValueError(
            "pass a ready preprocessor OR constructor kwargs, not both")
    return preprocessor


def preprocess_record(record, *, preprocessor=None, **kwargs):
    """Module-level shim for a one-off record."""
    return _resolve_preprocessor(preprocessor, **kwargs).preprocess_record(
        record)


def preprocess_records(records, *, preprocessor=None, **kwargs):
    """Module-level shim for a one-off volume of records."""
    return _resolve_preprocessor(preprocessor, **kwargs).preprocess_records(
        records)
