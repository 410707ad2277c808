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

The non-blocking snapshot (JAX :131-225, ``--ckpt-async``):
:func:`save_resume_async` copies every tensor into host memory that the
caller no longer touches before it returns, writes ``host.json`` into
``<dir>.tmp`` and leaves ``state.pt`` to one background thread; the
:class:`PendingSnapshot` it returns publishes the directory at
``finalize()``. JAX's orbax copies its immutable arrays to the host before
it returns; here the optimizer and BatchNorm update their tensors in
place, so a card's tensors are copied on its current stream, which orders
the copies before the next step's kernels, and the writer waits on an
event recorded after them. :class:`ResumeWriter` is the trainers' one
snapshot path, blocking or not.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import barrier

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


def _host_copy(tree: Any, devices: set) -> Any:
    """A copy of the tensors of a nested dict / list in host memory of its
    own: a card's tensor into pinned memory on the card's current stream
    (its device goes into ``devices``, for an event after the copies),
    any other by a synchronous copy."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if not t.is_cuda:
            return t.to("cpu", copy=True)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        devices.add(t.device)
        return out
    if isinstance(tree, dict):
        return {k: _host_copy(v, devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v, devices) for v in tree]
    return tree


def _start_tmp(dirpath: str, host_state: Dict[str, Any]) -> str:
    """A fresh ``<dirpath>.tmp`` holding ``host.json``; returns it."""
    tmp = dirpath + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "host.json"), "w", encoding="utf-8") as f:
        json.dump(host_state, f, indent=2)
    return tmp


def _publish(tmp: str, dirpath: str) -> None:
    if os.path.isdir(dirpath):
        shutil.rmtree(dirpath)
    os.replace(tmp, dirpath)


def save_train_state(dirpath: str, tensors: Dict[str, Any],
                     host_state: Dict[str, Any]) -> None:
    """A snapshot: ``tensors`` (nested dicts / lists of tensors and
    numbers) in ``state.pt``, ``host_state`` in ``host.json``, written
    into ``<dirpath>.tmp`` and then renamed to ``dirpath``."""
    tmp = _start_tmp(dirpath, host_state)
    torch.save(_cpu(tensors), os.path.join(tmp, "state.pt"))
    _publish(tmp, dirpath)


class PendingSnapshot:
    """A snapshot whose ``state.pt`` is being written in the background.
    Until :meth:`finalize` it is ``<dir>.tmp``, which
    :func:`latest_resume_dir` skips, so a crash before it falls back to
    the previous snapshot as a crash inside a blocking save does."""

    def __init__(self, dirpath: str, thread: Optional[threading.Thread],
                 errors: List[BaseException], out_dir: Optional[str],
                 keep: int, group=None):
        self._dirpath = dirpath
        self._thread = thread
        self._errors = errors
        self._out_dir = out_dir
        self._keep = keep
        self._group = group
        self._done = False

    def finalize(self) -> str:
        """Wait for the write, raise its error (the ``.tmp`` removed,
        nothing published) or rename ``<dir>.tmp`` to ``<dir>`` and prune
        to ``keep``; then the group's barrier. A second call does
        nothing. Returns the directory."""
        if self._done:
            return self._dirpath
        self._done = True
        try:
            if self._thread is not None:
                self._thread.join()
                tmp = self._dirpath + ".tmp"
                if self._errors:
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise self._errors[0]
                _publish(tmp, self._dirpath)
                if self._keep > 0 and self._out_dir:
                    prune_resume_dirs(self._out_dir, self._keep)
        finally:
            barrier(self._group)
        return self._dirpath


def _write_state(events: list, tensors: Any, path: str,
                 errors: List[BaseException]) -> None:
    """The writer thread: once the copies have run, ``state.pt``."""
    try:
        for event in events:
            event.synchronize()
        torch.save(tensors, path)
    except Exception as exc:          # raised again by finalize()
        errors.append(exc)


def save_train_state_async(dirpath: str, tensors: Dict[str, Any],
                           host_state: Dict[str, Any],
                           out_dir: Optional[str] = None, keep: int = 0,
                           group=None) -> PendingSnapshot:
    """:func:`save_train_state` without waiting for ``state.pt``: the
    tensors are copied off before it returns, so the caller may update
    them in place at once. ``finalize()`` of the returned handle
    publishes the directory, then prunes ``out_dir`` to ``keep``. Under a
    data-parallel ``group`` only its primary rank writes, and every
    rank's ``finalize()`` ends with the group's barrier."""
    thread, errors = None, []
    if group is None or group.primary:
        tmp = _start_tmp(dirpath, host_state)
        devices: set = set()
        host = _host_copy(tensors, devices)
        events = []
        for dev in devices:
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(dev))
        thread = threading.Thread(
            target=_write_state, name="resume-snapshot",
            args=(events, host, os.path.join(tmp, "state.pt"), errors))
        thread.start()
    return PendingSnapshot(dirpath, thread, errors, out_dir, keep, group)


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


def save_resume_async(out_dir: str, epoch: int, tensors: Dict[str, Any],
                      host_state: Dict[str, Any], step: Optional[int] = None,
                      keep: int = 0, group=None) -> PendingSnapshot:
    """:func:`save_resume` through :func:`save_train_state_async`: the
    same directory, published and pruned at ``finalize()``."""
    d = os.path.join(out_dir, "checkpoints", _resume_name(epoch, step))
    return save_train_state_async(d, tensors, host_state, out_dir=out_dir,
                                  keep=keep, group=group)


class ResumeWriter:
    """A trainer's resume snapshots: blocking (the primary rank writes,
    then the group's barrier), or with ``asynchronous`` one snapshot in
    flight at a time, the pending one finalized before the next starts and
    by :meth:`publishing` when the run ends or raises."""

    def __init__(self, out_dir: str, keep: int = 0,
                 asynchronous: bool = False, group=None):
        self.out_dir = out_dir
        self.keep = keep
        self.asynchronous = asynchronous
        self.group = group
        self.pending: Optional[PendingSnapshot] = None

    def save(self, epoch: int, tensors: Dict[str, Any],
             host_state: Dict[str, Any], step: Optional[int] = None
             ) -> None:
        if self.asynchronous:
            self.finalize()
            self.pending = save_resume_async(
                self.out_dir, epoch, tensors, host_state, step=step,
                keep=self.keep, group=self.group)
            return
        if self.group is None or self.group.primary:
            save_resume(self.out_dir, epoch, tensors, host_state, step=step,
                        keep=self.keep)
        barrier(self.group)

    def finalize(self) -> None:
        """Publish the snapshot in flight, if any."""
        pending, self.pending = self.pending, None
        if pending is not None:
            pending.finalize()

    @contextmanager
    def publishing(self, name: str):
        """Finalize after the block; when the block raises, the pending
        snapshot is still published, and a failure to publish it is
        printed and never masks the block's exception."""
        try:
            yield
        except BaseException:
            try:
                self.finalize()
            except Exception as exc:
                print(f"[{name}] finalize of the pending snapshot failed "
                      f"during crash handling: {exc!r}", flush=True)
            raise
        self.finalize()


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
