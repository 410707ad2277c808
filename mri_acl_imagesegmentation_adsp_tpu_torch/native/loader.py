"""ctypes bindings for the native npz loader (``native/npz_loader.cc``).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/native/loader.py``, the
same functions and contract: ``native_available``, ``load_npz_member``,
``load_volume_npz`` and ``load_volumes_npz`` return None where the native
path cannot serve (no ``g++`` or zlib, a member it does not parse), and the
caller falls back to ``np.load``. The library is built on first use into
``build/native/`` (``native/_build.py``). The C calls release the GIL, so
a thread pool inflates volumes in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from . import _build

_lib = None
_lock = threading.Lock()


class _VolumeOut(ctypes.Structure):
    """Mirror of npz_loader.cc's VolumeOut (natural C alignment)."""
    _fields_ = [
        ("img_data", ctypes.c_void_p), ("img_shape", ctypes.c_int64 * 8),
        ("img_ndim", ctypes.c_int32), ("img_itemsize", ctypes.c_int32),
        ("img_kind", ctypes.c_char),
        ("msk_data", ctypes.c_void_p), ("msk_shape", ctypes.c_int64 * 8),
        ("msk_ndim", ctypes.c_int32), ("msk_itemsize", ctypes.c_int32),
        ("msk_kind", ctypes.c_char),
        ("rc", ctypes.c_int32),
    ]


_KIND_TO_DTYPE = {
    ("f", 4): np.float32, ("f", 8): np.float64,
    ("u", 1): np.uint8, ("i", 1): np.int8,
    ("i", 2): np.int16, ("u", 2): np.uint16,
    ("i", 4): np.int32, ("u", 4): np.uint32,
    ("i", 8): np.int64, ("u", 8): np.uint64,
}


def _get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib if _lib != "unavailable" else None
        so = _build.build("npz_loader", ["-lz"])
        try:
            lib = ctypes.CDLL(so) if so else None
        except OSError as exc:
            _build.ERRORS["npz_loader"] = str(exc)
            lib = None
        if lib is None:
            _lib = "unavailable"
            return None
        ptr = ctypes.POINTER
        lib.npz_probe.restype = ctypes.c_int
        lib.npz_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ptr(ctypes.c_int64), ptr(ctypes.c_int), ptr(ctypes.c_char)]
        lib.npz_load.restype = ctypes.c_int
        lib.npz_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_void_p, ctypes.c_int64]
        lib.npz_load_volume.restype = ctypes.c_int
        lib.npz_load_volume.argtypes = [
            ctypes.c_char_p,
            ptr(ctypes.c_void_p), ptr(ctypes.c_int64), ptr(ctypes.c_int),
            ptr(ctypes.c_int), ptr(ctypes.c_char),
            ptr(ctypes.c_void_p), ptr(ctypes.c_int64), ptr(ctypes.c_int),
            ptr(ctypes.c_int), ptr(ctypes.c_char)]
        lib.npz_free.restype = None
        lib.npz_free.argtypes = [ctypes.c_void_p]
        lib.npz_load_volumes.restype = ctypes.c_int
        lib.npz_load_volumes.argtypes = [
            ptr(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ptr(_VolumeOut)]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the native npz loader built and loaded."""
    return _get_lib() is not None


def load_npz_member(path: str, member: str) -> Optional[np.ndarray]:
    """One ``.npy`` member of an npz through the native reader; None on any
    failure (the caller falls back to ``np.load``)."""
    lib = _get_lib()
    if lib is None:
        return None
    shape = (ctypes.c_int64 * 8)()
    itemsize = ctypes.c_int()
    kind = ctypes.c_char()
    ndim = lib.npz_probe(path.encode(), member.encode(), shape,
                         ctypes.byref(itemsize), ctypes.byref(kind))
    if ndim < 0:
        return None
    dtype = _KIND_TO_DTYPE.get((kind.value.decode(), itemsize.value))
    if dtype is None:
        return None
    out = np.empty(tuple(int(shape[i]) for i in range(ndim)), dtype=dtype)
    rc = lib.npz_load(path.encode(), member.encode(),
                      out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    return out if rc == 0 else None


def _wrap_raw(ptr: int, shape_arr, ndim: int, itemsize: int,
              kind: bytes) -> Optional[np.ndarray]:
    """A copy of the C-allocated array at ``ptr`` (the caller frees it)."""
    dims = tuple(int(shape_arr[i]) for i in range(ndim))
    dtype = _KIND_TO_DTYPE.get((kind.decode(), itemsize))
    if dtype is None:
        return None
    n = int(np.prod(dims)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_uint8 * n).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).reshape(dims).copy()


def load_volume_npz(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(img, msk)`` of a packed ``volume.npz`` in one pass over the file
    (one read and one inflate a member); None -> the caller falls back."""
    lib = _get_lib()
    if lib is None:
        return None
    img_p, msk_p = ctypes.c_void_p(), ctypes.c_void_p()
    img_shape, msk_shape = (ctypes.c_int64 * 8)(), (ctypes.c_int64 * 8)()
    img_nd, msk_nd = ctypes.c_int(), ctypes.c_int()
    img_is, msk_is = ctypes.c_int(), ctypes.c_int()
    img_k, msk_k = ctypes.c_char(), ctypes.c_char()
    rc = lib.npz_load_volume(
        path.encode(),
        ctypes.byref(img_p), img_shape, ctypes.byref(img_nd),
        ctypes.byref(img_is), ctypes.byref(img_k),
        ctypes.byref(msk_p), msk_shape, ctypes.byref(msk_nd),
        ctypes.byref(msk_is), ctypes.byref(msk_k))
    try:
        if rc != 0:
            return None
        img = _wrap_raw(img_p.value, img_shape, img_nd.value, img_is.value,
                        img_k.value)
        msk = _wrap_raw(msk_p.value, msk_shape, msk_nd.value, msk_is.value,
                        msk_k.value)
        return None if img is None or msk is None else (img, msk)
    finally:
        if img_p.value:
            lib.npz_free(img_p)
        if msk_p.value:
            lib.npz_free(msk_p)


def load_volumes_npz(paths, threads: int = 8):
    """Many ``volume.npz`` archives on a C++ thread pool
    (``npz_load_volumes``: no Python threads between files). Returns a list
    aligned with ``paths`` of ``(img, msk)`` or None (that volume falls
    back); None as a whole where the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    outs = (_VolumeOut * n)()
    carr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.npz_load_volumes(carr, n, int(threads), outs)
    results = []
    try:
        for o in outs:
            if o.rc != 0 or not o.img_data or not o.msk_data:
                results.append(None)
                continue
            img = _wrap_raw(o.img_data, o.img_shape, o.img_ndim,
                            o.img_itemsize, o.img_kind)
            msk = _wrap_raw(o.msk_data, o.msk_shape, o.msk_ndim,
                            o.msk_itemsize, o.msk_kind)
            results.append(None if img is None or msk is None
                           else (img, msk))
    finally:
        for o in outs:
            if o.img_data:
                lib.npz_free(o.img_data)
            if o.msk_data:
                lib.npz_free(o.msk_data)
    return results
