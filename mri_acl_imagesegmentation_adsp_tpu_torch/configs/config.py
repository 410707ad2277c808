"""Environment-sourced dataset roots.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/configs/config.py``: a ``.env`` file
near the project root is loaded into ``os.environ`` without overriding
what is set, the five dataset roots are module globals, and a missing one
prints a warning. The search for the file is the working directory and its
parents up to the project root (the directory that holds the package) when
the working directory lies inside it, else the working directory and then
the project root: a ``.env`` above the project never reaches the program.
Only the five roots are set from the file. Here the file is read, and the
warnings printed, at the first use of a global (PEP 562 ``__getattr__``),
not at import; a global reads the environment at each use, so a root set
after the first use is seen.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

ENV_KEYS = [
    "FASTMRI_ROOT",
    "OAI_ZIB_ROOT",
    "KAGGLE_KNEE_PCK_ROOT",
    "KNEE_MRI_ROOT",
    "SKM_TEA_MAIN_ROOT",
]

# the directory that holds the package: the .env search ends there
PROJECT_ROOT = Path(__file__).resolve().parents[2]

_env_loaded = False


def _env_candidates() -> List[Path]:
    """The ``.env`` files searched, first to last."""
    cwd = Path.cwd().resolve()
    if cwd == PROJECT_ROOT:
        dirs = [cwd]
    elif PROJECT_ROOT in cwd.parents:
        dirs = [cwd, *cwd.parents[:cwd.parents.index(PROJECT_ROOT) + 1]]
    else:
        dirs = [cwd, PROJECT_ROOT]
    return [d / ".env" for d in dirs]


def load_env(path: Optional[str] = None, override: bool = False
             ) -> Dict[str, str]:
    """Load the dataset roots (``ENV_KEYS``) of a ``.env`` file's
    ``KEY=VALUE`` lines into ``os.environ``; without ``path``, the first
    ``.env`` of the search above. Returns the roots the file holds; other
    keys are ignored."""
    candidates = [Path(path)] if path else _env_candidates()
    loaded: Dict[str, str] = {}
    for cand in candidates:
        if cand.is_file():
            for line in cand.read_text(encoding="utf-8").splitlines():
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip().strip("'\"")
                if k not in ENV_KEYS:
                    continue
                if override or k not in os.environ:
                    os.environ[k] = v
                loaded[k] = v
            break
    return loaded


def __getattr__(name: str) -> Optional[str]:
    global _env_loaded
    if name not in ENV_KEYS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    if not _env_loaded:
        _env_loaded = True
        load_env()
        for key in ENV_KEYS:
            if not os.getenv(key):
                print(f"[WARN] {key} is not set in .env or environment")
    return os.getenv(name)


__all__ = ["ENV_KEYS", "load_env", *ENV_KEYS]
