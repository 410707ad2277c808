"""Build a host C++ source of ``native/`` into a shared library.

``g++`` compiles ``native/<name>.cc`` into ``build/native/`` at the root of
the checkout (a directory ``.gitignore`` lists), never beside the source;
the library's name carries a hash of the source and the command, so an edit
rebuilds it and an unchanged source is loaded as it is. A build that fails
(no ``g++``, no zlib) returns None, and the caller takes its numpy or h5py
path: these readers are host I/O, not the device.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# why the last build of each source failed, for callers that report it
ERRORS: Dict[str, str] = {}


def library_path(name: str, libs: Sequence[str]) -> Path:
    """Where the library for ``native/<name>.cc`` linked with ``libs`` is
    built."""
    digest = hashlib.sha256((HERE / f"{name}.cc").read_bytes()
                            + " ".join(libs).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, libs: Sequence[str]) -> Optional[str]:
    """Compile ``native/<name>.cc`` unless its library is already built;
    the library's path, or None if the build fails. Writes to a temporary
    name and renames, so a concurrent or cut-off build never leaves a
    half-written library under the final name."""
    out = library_path(name, libs)
    if out.exists():
        return str(out)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                        str(HERE / f"{name}.cc"), *libs, "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as exc:
        tmp.unlink(missing_ok=True)
        ERRORS[name] = (getattr(exc, "stderr", None) or str(exc)).strip()
        return None
    return str(out)
