"""Best-model checkpoints and resume snapshots in the port's own format.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/checkpoint.py``:
``save_best`` / ``load_best`` (:41-56) and the resume snapshots,
``save_train_state`` (:79-128), ``save_resume``, ``prune_resume_dirs``,
``load_train_state`` and ``latest_resume_dir`` (:219-338), which write
flax msgpack or orbax. Here the best bundle is the reference's own
``{"model": state_dict}`` written with ``torch.save``, with the run's
arguments as JSON beside it in ``<path>.args.json``. A resume snapshot is
the JAX package's directory layout, ``<out>/checkpoints/resume_%06d`` (an
epoch boundary: that many epochs done) or ``resume_%06d_%06d`` (mid-epoch:
epochs done, then steps done in the next), holding ``state.pt`` (a
``torch.save`` of nested dicts and lists of tensors) and ``host.json``
(counters, history, scheduler). It is written into ``<dir>.tmp`` and
renamed, so a crash mid-write leaves no snapshot that
:func:`latest_resume_dir` would pick. Every load reads tensors only
(``weights_only=True``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import torch

# prune_resume_dirs spares *.tmp dirs younger than this: they may be a
# concurrent writer's snapshot in flight
_TMP_GRACE_S = 300.0


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


def _cpu(tree: Any) -> Any:
    """Tensors of a nested dict / list moved to the CPU, detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def save_train_state(dirpath: str, tensors: Dict[str, Any],
                     host_state: Dict[str, Any]) -> None:
    """A snapshot: ``tensors`` (nested dicts / lists of tensors and
    numbers) in ``state.pt``, ``host_state`` in ``host.json``, written
    into ``<dirpath>.tmp`` and then renamed to ``dirpath``."""
    tmp = dirpath + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(_cpu(tensors), os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "host.json"), "w", encoding="utf-8") as f:
        json.dump(host_state, f, indent=2)
    if os.path.isdir(dirpath):
        shutil.rmtree(dirpath)
    os.replace(tmp, dirpath)


def _resume_name(epoch: int, step: Optional[int]) -> str:
    return (f"resume_{epoch:06d}" if step is None
            else f"resume_{epoch:06d}_{step:06d}")


def _sort_key(name: str) -> tuple:
    # (epochs done,) < (epochs done, steps) < (epochs done + 1,)
    return tuple(int(p) for p in name.split("_")[1:])


def _complete(full: str) -> bool:
    return (os.path.isfile(os.path.join(full, "state.pt"))
            and os.path.isfile(os.path.join(full, "host.json")))


def save_resume(out_dir: str, epoch: int, tensors: Dict[str, Any],
                host_state: Dict[str, Any], step: Optional[int] = None,
                keep: int = 0) -> str:
    """``<out_dir>/checkpoints/resume_<epoch>[_<step>]``: ``epoch`` epochs
    done, and with ``step`` that many steps into the next. With ``keep`` >
    0, once the new snapshot is in place only the newest ``keep`` complete
    snapshots stay (:func:`prune_resume_dirs`). Returns the directory."""
    d = os.path.join(out_dir, "checkpoints", _resume_name(epoch, step))
    save_train_state(d, tensors, host_state)
    if keep > 0:
        prune_resume_dirs(out_dir, keep)
    return d


def prune_resume_dirs(out_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete resume snapshots, and
    any ``*.tmp`` left by a crashed save that is older than a grace period
    (a younger one may be a write in flight)."""
    root = os.path.join(out_dir, "checkpoints")
    if keep <= 0 or not os.path.isdir(root):
        return
    complete = []
    for name in sorted(os.listdir(root)):
        if not name.startswith("resume_"):
            continue
        full = os.path.join(root, name)
        if name.endswith(".tmp"):
            try:
                recent = time.time() - os.path.getmtime(full) < _TMP_GRACE_S
            except OSError:
                recent = False
            if not recent:
                shutil.rmtree(full, ignore_errors=True)
        elif _complete(full):
            complete.append(name)
    complete.sort(key=_sort_key)
    for name in complete[:-keep]:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def load_train_state(dirpath: str,
                     map_location: str | torch.device = "cpu"
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(tensors, host_state)`` of a snapshot directory."""
    tensors = torch.load(os.path.join(dirpath, "state.pt"),
                         map_location=map_location, weights_only=True)
    with open(os.path.join(dirpath, "host.json"), "r",
              encoding="utf-8") as f:
        return tensors, json.load(f)


def latest_resume_dir(out_dir: str) -> Optional[str]:
    """The newest complete snapshot under ``<out_dir>/checkpoints``, or
    None; incomplete directories and ``*.tmp`` are skipped."""
    root = os.path.join(out_dir, "checkpoints")
    if not os.path.isdir(root):
        return None
    cands = [d for d in os.listdir(root)
             if d.startswith("resume_") and not d.endswith(".tmp")
             and _complete(os.path.join(root, d))]
    if not cands:
        return None
    return os.path.join(root, max(cands, key=_sort_key))
