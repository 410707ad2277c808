"""Build a CUDA source of ``csrc/`` into a C-ABI shared library, load it.

``nvcc`` compiles the source for ``sm_90a`` into ``build/torch_kernels/`` at
the root of the checkout (a directory ``.gitignore`` lists); the library's
name carries a hash of the source and the flags, so an edit rebuilds it and
an unchanged source is loaded as it is. The library exposes plain C
functions that the wrappers call through ``ctypes``: a build takes seconds,
where a source including PyTorch's headers would take minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels build only where the toolkit is")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Writes to a temporary name and renames, so a concurrent or cut-off build
    never leaves a half-written library under the final name. Prints the
    build's seconds to standard error, on a line of their own, and keeps
    what ``ptxas -v`` said (registers, shared memory, spills) beside the
    library (:func:`ptxas_report`)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    print(f"built {out.name} in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    return out


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<name>.cu`` once
    per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
