"""Native (C++) host readers, loaded with ctypes.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/native/``: a ZIP/deflate
npz reader (``npz_loader.cc``) that the slice store's ingest uses, and an
HDF5 slab reader (``h5_reader.cc``) that inflates the gzip chunks of raw
k-space files in parallel. Built with ``g++`` on first use into
``build/native/`` (``_build.py``); every consumer has a numpy or h5py
path, so the port works without a toolchain.
"""

from .h5loader import (import_h5py, load_h5_slab, native_h5_available,
                       read_h5_slab)
from .loader import (load_npz_member, load_volume_npz, load_volumes_npz,
                     native_available)

__all__ = ["native_available", "load_npz_member", "load_volume_npz",
           "load_volumes_npz", "native_h5_available", "read_h5_slab",
           "load_h5_slab", "import_h5py"]
