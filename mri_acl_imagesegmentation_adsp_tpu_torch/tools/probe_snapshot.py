"""How long a trainer waits for its resume snapshot, blocking and with
``--ckpt-async``, at full width.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_snapshot \\
        [--work /tmp/probe_snapshot] [--out probe_snapshot.json] [--device cuda]

Two trainers' states: the launcher's ResNet34 U-Net at batch 8 (the corpus
b8 bar's flags, on two corpus volumes packed in memory) and VarNet at the
protocol recipe's configuration (``tools/varnet_synthetic.py``). Each
takes ``STEPS`` train steps first, so that its optimizer state is a real
one. Then, ``REPEATS`` times, with the card synchronized before each
call, ``_save_resume`` is timed on the host clock:

- blocking: the whole call (the copies to the host, ``torch.save``, the
  rename);
- async: the call (the copies issued on the card's stream, ``host.json``,
  the writer started), then the card's time to finish the copies (a
  synchronize right after), then ``finalize()`` at once (the rest of the
  write and the rename), which a run pays only when the next snapshot
  comes before the write ends.

Snapshots go to ``--work`` (pruned to one); ``state_bytes`` is the
tensors' size. Prints one JSON line, also written to ``--out``, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List

import torch

from ..cli import launcher
from ..data.hbm_loader import epoch_permutation
from ..train import checkpoint as ckpt_lib
from ..train.varnet_trainer import VarNetArgs, VarNetTrainer
from ..utils.device import resolve_device
from . import corpus_run, varnet_synthetic
from .make_corpus import make_corpus

STEPS = 2
REPEATS = 3
PACK_SLICES = 40           # two volumes: 16 slices each in the band


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_saves(trainer, save: Callable[[], None], dev: torch.device,
               out_dir: str) -> Dict[str, List[float]]:
    """Seconds of ``save()`` with the trainer's writer blocking, then
    async: the call, the copies' card time after it, ``finalize()``."""
    out: Dict[str, List[float]] = {"blocking_s": [], "async_call_s": [],
                                   "async_copies_s": [],
                                   "async_finalize_s": []}
    for asynchronous in (False, True):
        trainer.snapshots = ckpt_lib.ResumeWriter(
            out_dir, keep=1, asynchronous=asynchronous,
            group=getattr(trainer, "group", None))
        for _ in range(REPEATS):
            _sync(dev)
            t0 = time.perf_counter()
            save()
            t1 = time.perf_counter()
            if not asynchronous:
                out["blocking_s"].append(t1 - t0)
                continue
            _sync(dev)
            t2 = time.perf_counter()
            trainer.snapshots.finalize()
            t3 = time.perf_counter()
            out["async_call_s"].append(t1 - t0)
            out["async_copies_s"].append(t2 - t1)
            out["async_finalize_s"].append(t3 - t2)
    return out


def unet_b8(work: str, dev: torch.device) -> Dict:
    packs = os.path.join(work, "packs")
    make_corpus(packs, volumes=2, slices=PACK_SLICES, device=dev)
    lists = os.path.join(work, "lists")
    flags = ["--skip-preprocess", "--artifact-dir", packs, "--list-dir",
             lists, "--out-dir", os.path.join(work, "unet"),
             *corpus_run.COMMON_FLAGS, *corpus_run.BARS["b8"]["flags"],
             "--split-ratio", "0.5", "--device", str(dev)]
    if launcher.main(flags + ["--skip-train"]) != 0:
        raise RuntimeError("the launcher's split failed")
    parser = launcher.build_parser()
    ns = launcher.apply_preset(parser, parser.parse_args(flags), flags)
    t = launcher.build_trainer(os.path.join(lists, "train.txt"),
                               os.path.join(lists, "val.txt"),
                               ns.out_dir, ns)
    perm = epoch_permutation(t.perm_gen, t.train_store.num_slices,
                             ns.batch_size, drop_last=True)
    t.engine.train_steps(t.train_store, perm[:STEPS], t.aug_gen)
    _sync(dev)
    times = time_saves(t, lambda: t._save_resume(1), dev, ns.out_dir)
    return {"batch": ns.batch_size, "amp": ns.amp,
            "state_bytes": _bytes(t._tensor_state()), **times}


def varnet_protocol(work: str, dev: torch.device) -> Dict:
    train, _ = varnet_synthetic.make_samples("protocol", "train")
    args = VarNetArgs(out_dir=os.path.join(work, "varnet"),
                      **varnet_synthetic.RECIPES["protocol"]["args"])
    t = VarNetTrainer(args, device=dev)
    t._init_if_needed(train[0].kspace, train[0].espirit)
    for _ in range(STEPS):
        t._step_batch(train[:1])
    _sync(dev)
    state = {"model": t.model.state_dict(),
             "optimizer": t.optimizer.state_dict()}
    times = time_saves(t, lambda: t._save_resume(1), dev, args.out_dir)
    return {"config": "protocol", "amp": args.amp,
            "state_bytes": _bytes(state), **times}


def run(work: str, device: str = "cuda") -> Dict:
    dev = resolve_device(device)
    return {"tool": "probe_snapshot", "device": str(dev),
            "unet_b8": unet_b8(work, dev),
            "varnet_protocol": varnet_protocol(work, dev),
            "card": corpus_run.card_line()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None,
                    help="where the snapshots go (default: a temporary "
                         "directory, removed after)")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ns = ap.parse_args(argv)
    if ns.work:
        corpus_run.print_line(run(ns.work, ns.device), ns.out)
    else:
        with tempfile.TemporaryDirectory() as work:
            corpus_run.print_line(run(work, ns.device), ns.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
