"""Config layer: env-sourced dataset roots + the YAML component registry.

The dataset-root globals resolve at their first use (``config.py``)."""

from . import config
from .config import ENV_KEYS, load_env
from .registry import build_from_spec, build_from_yaml, load_component

__all__ = [*ENV_KEYS, "load_env", "load_component", "build_from_spec",
           "build_from_yaml"]


def __getattr__(name: str):
    if name in ENV_KEYS:
        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
