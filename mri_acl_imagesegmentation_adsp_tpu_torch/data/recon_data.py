"""Raw-data access of the prostate reconstructions: the ISMRMRD header
queries, the case loaders and the result writer.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/recon_data.py:27-100``
(``et_query``, ``get_regridding_params``, ``load_file_T2``,
``load_file_dwi``, ``save_recon``), after the prostate code's
``data/mri_data.py``. The loaders and the writer need h5py; without it they
raise an ImportError that names it. The per-slice VarNet datasets
(``SliceDataset``, ``FastMriDataModule``) are not ported yet.
"""

from __future__ import annotations

import xml.etree.ElementTree as etree
from typing import Dict, Optional, Tuple

import numpy as np

from ..native import import_h5py

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
