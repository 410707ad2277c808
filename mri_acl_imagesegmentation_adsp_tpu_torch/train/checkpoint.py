"""Best-model checkpoints in the port's own format.

Counterpart: ``save_best`` / ``load_best`` in
``mri_acl_imagesegmentation_adsp_tpu/train/checkpoint.py:41-56``, which
write flax msgpack. Here the bundle is the reference's own
``{"model": state_dict}`` shape written with ``torch.save``, with the run's
arguments as JSON beside it in ``<path>.args.json``; loading reads tensors
only (``weights_only=True``)."""

from __future__ import annotations

import json
from typing import Any, Dict

import torch


def save_best(path: str, state_dict: Dict[str, torch.Tensor],
              args_dict: Dict[str, Any]) -> None:
    """Write ``{"model": state_dict}`` to ``path`` and the args beside it."""
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"model": cpu}, path)
    with open(path + ".args.json", "w", encoding="utf-8") as f:
        json.dump(args_dict, f, indent=2)


def load_best(path: str, map_location: str | torch.device = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """The state_dict saved by :func:`save_best`."""
    bundle = torch.load(path, map_location=map_location, weights_only=True)
    if not isinstance(bundle, dict) or "model" not in bundle:
        raise ValueError(f"{path} is not a {{'model': state_dict}} bundle")
    return bundle["model"]
