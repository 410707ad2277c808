"""ctypes bindings for the native HDF5 slab reader (``native/h5_reader.cc``).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/native/h5loader.py``, the
same functions and contract. ``read_h5_slab(path, dset, indices, axis)``
reads ``dataset[..., indices, ...]`` (``indices`` along ``axis``) on a C++
thread pool: libhdf5 is entered only for a short metadata pass, and the raw
chunks are read, inflated, unshuffled and scattered concurrently, outside
h5py's global lock. It returns None wherever the native path cannot serve
(no toolchain, no system libhdf5, no h5py for the dtype, a big-endian or
unusual filter, a compact layout), and ``load_h5_slab`` then reads through
h5py, so its results are always h5py's.

The library is built on first use into ``build/native/``
(``native/_build.py``) and ``dlopen``s only a *system* libhdf5. Where
neither a system libhdf5 nor h5py exists, ``load_h5_slab`` and every
``.h5`` entry point of the port raise an ``ImportError`` that names h5py
(:func:`import_h5py`).
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading
from typing import Optional, Sequence

import numpy as np

from . import _build

_lib = None
_lock = threading.Lock()


def import_h5py(what: str = "reading .h5 files"):
    """The ``h5py`` module, or an ImportError that says ``what`` needs it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"{what} needs h5py, which is not installed here (the native "
            "reader serves only with a system libhdf5 and h5py's metadata); "
            "install h5py, or use a route that reads no .h5 file") from exc
    return h5py


def _candidate_hdf5_libs():
    """System libhdf5 ``.so`` candidates only. h5py's bundled copy is not
    one: ``dlopen`` of a library the process already loaded returns the same
    instance, so the C++ threads would share one non-thread-safe serial
    HDF5 with h5py's own calls, each lock guarding half the callers."""
    pats = [
        "/lib/x86_64-linux-gnu/libhdf5_serial.so*",
        "/usr/lib/x86_64-linux-gnu/libhdf5_serial.so*",
        "/usr/lib/libhdf5_serial.so*",
        "/usr/lib/x86_64-linux-gnu/libhdf5.so*",
    ]
    out = []
    for p in pats:
        out.extend(sorted(glob.glob(p)))
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib if _lib != "unavailable" else None
        so = _build.build("h5_reader", ["-lz", "-ldl"])
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
                lib.h5n_init.restype = ctypes.c_int
                lib.h5n_init.argtypes = [ctypes.c_char_p]
                lib.h5n_probe.restype = ctypes.c_int
                lib.h5n_probe.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32)]
                lib.h5n_read_slab.restype = ctypes.c_int
                lib.h5n_read_slab.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int32,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
                for cand in _candidate_hdf5_libs():
                    if lib.h5n_init(cand.encode()) == 0:
                        _lib = lib
                        return lib
            except OSError as exc:
                _build.ERRORS["h5_reader"] = str(exc)
        _lib = "unavailable"
        return None


def native_h5_available() -> bool:
    """Whether the native reader built and found a system libhdf5."""
    return _get_lib() is not None


# (path, dset) -> (mtime_ns, size, dtype, shape): spares an h5py open for
# the type metadata on every per-slice read (the native side keeps its own
# chunk-table cache under the same key)
_meta_cache: dict = {}


def _dtype_shape(path: str, dset: str):
    st = os.stat(path)
    key = (path, dset)
    hit = _meta_cache.get(key)
    if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
        return hit[2], hit[3]
    import h5py
    with h5py.File(path, "r") as hf:
        node = hf.get(dset)
        if node is None or not hasattr(node, "dtype"):
            return None, None
        dtype, shape = node.dtype, node.shape
    if len(_meta_cache) > 4096:
        _meta_cache.clear()
    _meta_cache[key] = (st.st_mtime_ns, st.st_size, dtype, shape)
    return dtype, shape


def read_h5_slab(path: str, dset: str, indices: Sequence[int],
                 axis: int = 0,
                 threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Native parallel read of ``dataset[..., indices, ...]``: an array
    shaped as the dataset with ``shape[axis]`` replaced by
    ``len(indices)``, or None on any case it does not serve (the caller
    falls back to h5py). The dtype comes from h5py's metadata."""
    lib = _get_lib()
    if lib is None:
        return None
    if threads is None:
        threads = os.cpu_count() or 1  # the C side caps it at the cores
    idx = np.asarray(indices, dtype=np.int64).ravel()
    if idx.size == 0 or len(set(idx.tolist())) != idx.size:
        return None
    try:
        dtype, shape = _dtype_shape(path, dset)
    except (ImportError, OSError, ValueError, KeyError, RuntimeError):
        return None
    if dtype is None:
        return None
    if axis < 0:
        axis += len(shape)
    if not 0 <= axis < len(shape):
        return None
    # the native view of the file must agree before it is trusted
    cshape = (ctypes.c_int64 * 8)()
    itemsize = ctypes.c_int32()
    ndim = lib.h5n_probe(path.encode(), dset.encode(), cshape,
                         ctypes.byref(itemsize))
    if (ndim != len(shape) or itemsize.value != dtype.itemsize
            or tuple(cshape[i] for i in range(ndim)) != tuple(shape)):
        return None
    out = np.empty(tuple(idx.size if d == axis else shape[d]
                         for d in range(ndim)), dtype=dtype)
    rc = lib.h5n_read_slab(
        path.encode(), dset.encode(),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.size, axis, out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        int(threads))
    return out if rc == 0 else None


def load_h5_slab(path: str, dset: str, indices: Sequence[int],
                 axis: int = 0, threads: Optional[int] = None) -> np.ndarray:
    """``dataset[..., indices, ...]`` through the native reader where it
    serves, else through h5py; raises an ImportError naming h5py where
    neither can."""
    out = read_h5_slab(path, dset, indices, axis=axis, threads=threads)
    if out is not None:
        return out
    h5py = import_h5py(f"reading {dset!r} of {path}")
    with h5py.File(path, "r") as hf:
        data = hf[dset]
        sel = [slice(None)] * data.ndim
        ax = axis if axis >= 0 else axis + data.ndim
        # h5py's fancy selection wants strictly increasing, unique indices:
        # read the unique set and gather it back into the requested order
        uniq, inv = np.unique(np.asarray(list(indices), np.int64),
                              return_inverse=True)
        sel[ax] = uniq
        return np.take(data[tuple(sel)], inv, axis=ax)
