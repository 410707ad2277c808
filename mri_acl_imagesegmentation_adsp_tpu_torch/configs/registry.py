"""YAML component registry.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/configs/registry.py``: a
``class_path: "module:callable"`` plus ``init_args`` spec is resolved and
called, so a run spec can swap models or losses declaratively. The port's
``configs/knee_acl.yaml`` names the port's ``build_unet``:

    model:
      class_path: "mri_acl_imagesegmentation_adsp_tpu_torch.models.factory:build_unet"
      init_args: {model: unet, encoder: resnet34, classes: 1}

Reading a YAML file needs PyYAML; without it ``build_from_yaml`` raises an
ImportError that names it (``build_from_spec`` takes the dict itself).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict


def load_component(class_path: str):
    """Resolve ``"package.module:attr"`` (or ``"package.module.attr"``)."""
    module_name, _, attr = class_path.partition(":")
    if not attr:
        module_name, _, attr = class_path.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def build_from_spec(spec: Dict[str, Any]):
    fn = load_component(spec["class_path"])
    return fn(**(spec.get("init_args", {}) or {}))


def build_from_yaml(path: str, key: str | None = None):
    """Build the component under ``key`` of a YAML spec file, or its
    single top-level component when ``key`` is None."""
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(f"reading {path} needs PyYAML, which is not "
                          "installed here; pass the spec to "
                          "build_from_spec") from exc
    with open(path, "r", encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    if key is not None:
        return build_from_spec(doc[key])
    if "class_path" in doc:
        return build_from_spec(doc)
    if len(doc) == 1:
        return build_from_spec(next(iter(doc.values())))
    raise ValueError(f"Ambiguous YAML spec {path}: pass key= one of {list(doc)}")
