"""Raw-data access of the prostate reconstructions: the ISMRMRD header
queries, the case loaders and the result writer.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/recon_data.py:27-100``
(``et_query``, ``get_regridding_params``, ``load_file_T2``,
``load_file_dwi``, ``save_recon``), after the prostate code's
``data/mri_data.py``, and the per-slice VarNet datasets (:103-223 there):
``SliceDataset`` (one example a DWI slice: ISMRMRD sizes and phase-encode
limits from the header, the b50 or b1000 averages, each average regridded
along the readout on ``device`` (``recon/dwi.py``), real pairs, k-space
``(coils, aves, h, w, 2)``, ESPIRiT maps ``(coils, 1, h, w, 2)``, the target
flipped up-down) and ``FastMriDataModule``. Metadata comes through h5py,
the slabs through the native reader (``native.load_h5_slab``). Everything
here needs h5py; without it each entry raises an ImportError that names
it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as etree
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..native import import_h5py, load_h5_slab
from ..parallel.mesh import volume_affine_shards
from ..recon.dwi import trapezoidal_regridding

_ISMRMRD_NS = "http://www.ismrm.org/ISMRMRD"


def _q(tag: str) -> str:
    """Clark-notation qualified ISMRMRD tag for ElementTree lookups."""
    return "{%s}%s" % (_ISMRMRD_NS, tag)


def et_query(root, qlist, namespace: str = _ISMRMRD_NS) -> str:
    """Text of a nested ISMRMRD header element; ``qlist`` names its path
    from the root, e.g. ``["encoding", "encodedSpace", "matrixSize",
    "x"]``."""
    path = "/".join("{%s}%s" % (namespace, tag) for tag in qlist)
    node = root.find(path)
    if node is None:
        raise RuntimeError(
            f"ISMRMRD header element not found: {'/'.join(qlist)}")
    return str(node.text)


def get_regridding_params(hdr: str) -> Dict:
    """EPI ramp-sampling timing of an ISMRMRD header: the
    ``userParameterLong`` entries under ``encoding/trajectoryDescription``;
    absent ones stay None."""
    wanted = ("rampUpTime", "rampDownTime", "flatTopTime",
              "acqDelayTime", "echoSpacing")
    out: Dict[str, Optional[float]] = dict.fromkeys(wanted)
    root = etree.fromstring(hdr)
    traj_params = root.findall(
        f"{_q('encoding')}/{_q('trajectoryDescription')}"
        f"/{_q('userParameterLong')}")
    for param in traj_params:
        name = param.findtext(_q("name"))
        if name in out:
            out[name] = float(param.findtext(_q("value")))
    return out


def load_file_T2(fname: str) -> Tuple:
    """``(kspace, calibration_data, ismrmrd_header, reconstruction_rss,
    attrs)`` of a T2 case file."""
    h5py = import_h5py("loading a T2 case")
    with h5py.File(fname, "r") as hf:
        kspace = hf["kspace"][:]
        calibration_data = hf["calibration_data"][:]
        hdr = hf["ismrmrd_header"][()]
        im_recon = hf["reconstruction_rss"][:]
        atts = {k: hf.attrs[k] for k in
                ("max", "norm", "patient_id", "acquisition") if k in hf.attrs}
    return kspace, calibration_data, hdr, im_recon, atts


def load_file_dwi(fname: str) -> Tuple:
    """``(kspace, calibration_data, coil_sens_maps, EPI timing)`` of a DWI
    case file."""
    h5py = import_h5py("loading a DWI case")
    with h5py.File(fname, "r") as f:
        kspace = f["kspace"][:]
        calibration = f["calibration_data"][:]
        coil_sens_maps = f["coil_sens_maps"][:]
        hdr = get_regridding_params(f["ismrmrd_header"][()])
    return kspace, calibration, coil_sens_maps, hdr


def save_recon(outp_dict: Dict[str, np.ndarray], output_path: str) -> None:
    """One dataset a key of ``outp_dict`` in a new ``.h5`` file."""
    h5py = import_h5py("saving a reconstruction")
    with h5py.File(output_path, "w") as hf:
        for key, outp in outp_dict.items():
            hf.create_dataset(key, data=outp)


# b50: one NEX of x, y, z; b1000: four averages of x, y, z
_B50_AVERAGES = [8, 9, 10]
_B1000_AVERAGES = [5, 6, 7, 11, 12, 13, 17, 18, 19, 23, 24, 25]


class SliceDataset:
    """Per-slice DWI examples for VarNet training: every slice of every
    ``.h5`` under ``root``, sorted by file name; ``num_cols`` keeps the
    files whose encoded width is one of them. ``device`` runs the readout
    regridding."""

    def __init__(self, root: Union[str, Path, os.PathLike], bvalue: str,
                 transform: Optional[Callable] = None,
                 num_cols: Optional[Tuple[int, ...]] = None,
                 device: str | torch.device = "cuda"):
        import_h5py("the VarNet slice dataset")
        if bvalue not in ("b50", "b1000"):
            raise ValueError(f"unknown bvalue {bvalue}")
        self.transform = transform
        self.bvalue = bvalue
        self.device = device
        self.examples: List[Tuple] = []
        for fname in sorted(Path(root).iterdir()):
            metadata, num_slices = self._retrieve_metadata(fname)
            self.examples += [(fname, s, metadata) for s in range(num_slices)]
        if num_cols:
            self.examples = [ex for ex in self.examples
                             if ex[2]["encoding_size"][1] in num_cols]

    @staticmethod
    def _retrieve_metadata(fname):
        h5py = import_h5py("the VarNet slice dataset")
        with h5py.File(fname, "r") as hf:
            et_root = etree.fromstring(hf["ismrmrd_header"][()])
            enc = ["encoding", "encodedSpace", "matrixSize"]
            enc_size = tuple(int(et_query(et_root, enc + [d]))
                             for d in ("x", "y", "z"))
            rec = ["encoding", "reconSpace", "matrixSize"]
            recon_size = tuple(int(et_query(et_root, rec + [d]))
                               for d in ("x", "y", "z"))
            lims = ["encoding", "encodingLimits", "kspace_encoding_step_1"]
            enc_limits_center = int(et_query(et_root, lims + ["center"]))
            enc_limits_max = int(et_query(et_root, lims + ["maximum"])) + 1
            padding_left = enc_size[1] // 2 - enc_limits_center
            padding_right = padding_left + enc_limits_max
            num_slices = hf["kspace"].shape[1]
        metadata = {
            "padding_left": padding_left,
            "padding_right": padding_right,
            "encoding_size": enc_size,
            "recon_size": recon_size,
        }
        return metadata, num_slices

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int):
        h5py = import_h5py("the VarNet slice dataset")
        fname, slice_ind, metadata = self.examples[i]
        target_key = "trace_b50" if self.bvalue == "b50" else "trace_b1000"
        with h5py.File(fname, "r") as hf:
            regrid_params = get_regridding_params(hf["ismrmrd_header"][()])
            attrs = dict(hf.attrs)
        kspace = load_h5_slab(str(fname), "kspace", [slice_ind], axis=1)[:, 0]
        espirit = load_h5_slab(str(fname), "coil_sens_maps", [slice_ind],
                               axis=0)[0]
        target = load_h5_slab(str(fname), target_key, [slice_ind], axis=0)[0]
        kspace = kspace[_B50_AVERAGES if self.bvalue == "b50"
                        else _B1000_AVERAGES]
        kspace = np.stack([trapezoidal_regridding(k, regrid_params,
                                                  self.device)
                           for k in kspace])

        kspace = np.stack((kspace.real, kspace.imag), axis=-1)
        espirit = np.stack((espirit.real, espirit.imag), axis=-1)
        target = np.flip(target, 0)
        espirit = np.expand_dims(espirit, 1)
        kspace = np.transpose(kspace, [1, 0, 2, 3, 4])  # coils, aves, h, w

        attrs["max"] = np.max(target)
        attrs.update(metadata)

        if self.transform is None:
            return kspace, target, espirit, attrs, fname.name, slice_ind
        return self.transform(kspace, target, espirit, attrs, fname.name,
                              slice_ind)


class FastMriDataModule:
    """The train / val / test slice datasets of ``data_path`` (its
    ``train/`` and ``val/``, and ``test/`` or ``test_path`` when it is a
    directory), the prostate code's ``pl_modules/data_module.py``."""

    def __init__(self, data_path, bvalue: str, train_transform=None,
                 val_transform=None, test_transform=None, test_path=None,
                 batch_size: int = 1, num_workers: int = 0,
                 distributed_sampler: bool = False,
                 device: str | torch.device = "cuda"):
        root = Path(data_path)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.distributed_sampler = distributed_sampler
        self.train = SliceDataset(root / "train", bvalue, train_transform,
                                  device=device)
        self.val = SliceDataset(root / "val", bvalue, val_transform,
                                device=device)
        test_root = Path(test_path) if test_path else root / "test"
        self.test = (SliceDataset(test_root, bvalue, test_transform,
                                  device=device)
                     if test_root.is_dir() else None)

    def val_shards(self, n_shards: int) -> List[np.ndarray]:
        """The validation slices' indices on ``n_shards`` shards: whole
        volumes a shard, the largest first onto the least loaded, each
        shard padded to the longest by repeating its first entries
        (``parallel/mesh.py:volume_affine_shards``; a volume's slices are
        consecutive in ``val.examples``)."""
        counts: Dict[str, int] = {}
        for f, _, _ in self.val.examples:
            counts[str(f)] = counts.get(str(f), 0) + 1
        return volume_affine_shards(list(counts.values()), n_shards)
