"""ConvNeXt classification training and evaluation CLI (T2 and DWI).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/train_classify.py``
(the vendored ``train_t2.py``, ``train_dwi.py`` and ``test.py``), with the
same flags and YAML schema (``model_args`` / ``data`` / ``training``):
with ``--config-file`` the run directory is
``results_fol/<rundir>_SEED_<seed>`` with the YAML copied in as
``params.txt``, the batch the vendored DataLoaders' 32 unless
``--batch-size`` is given; ``--index-seed`` maps an index to the JAX
package's seed sequence (``_seed_for_index``); after training, the best
checkpoint's loss and AUC on the test split go to ``test_metrics.json``;
``--evaluate CKPT`` reports them without training. Plus ``--device``
(default ``cuda``). The datasheet datasets need h5py and pandas, and a YAML
needs PyYAML; without them the CLI raises an ImportError that names the
module. ``--data-parallel N`` trains on ``N`` ranks that this process
spawns (``parallel.spawn``; ``cuda:0`` .. ``cuda:N-1``, or CPU ranks with
``--device cpu``), rank 0 writing the run directory; this process prints
rank 0's result.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.train_classify \\
      --mode dwi --config-file diffusion_final.yaml [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Optional

from ..classify.dataset import DWISliceDataset, T2SliceDataset
from ..classify.trainer import ClassifierArgs, ClassifierTrainer
from ..parallel.mesh import DataGroup, mesh_devices, spawn


def _seed_for_index(index: int) -> int:
    """The JAX package's deterministic seed of an index (not the vendored
    list of ten torch / numpy seeds)."""
    return (1000003 * (index + 1)) % (2 ** 31 - 1)


def _load_yaml(path: str) -> dict:
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(f"--config-file {path} needs PyYAML, which is "
                          "not installed here; pass the flags instead"
                          ) from exc
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f)


def _args_from_yaml(path: str, mode: str, seed: int) -> ClassifierArgs:
    """The vendored YAML schema (``model_args`` / ``data`` / ``training``)
    -> ClassifierArgs."""
    cfg = _load_yaml(path)
    m = cfg.get("model_args", {})
    tr = cfg.get("training", {})
    rundir = str(m.get("rundir", f"{mode}_run")) + f"_SEED_{seed}"
    out_dir = os.path.join(str(cfg.get("results_fol", "runs/classify")),
                           rundir)
    sched = str(m.get("scheduler", "exponentiallr")).lower()
    if sched not in ("exponentiallr", "multistep", "cosine", "plat", "none"):
        raise ValueError(f"unknown scheduler {sched!r}")
    model = str(m.get("model", "convnext")).lower()
    if model not in ("tiny", "convnext"):
        raise ValueError(f"unknown model {model!r}")
    return ClassifierArgs(
        out_dir=out_dir,
        model=model,
        diff=(mode == "dwi"),
        optimizer=str(m.get("optimizer", "adam")).lower(),
        amsgrad=bool(m.get("amsgrad", False)),
        scheduler=sched,
        lr=float(m.get("lr", 1e-4)),
        momentum=float(m.get("momentum", 0.9)),
        weight_decay=float(m.get("weight_decay", 1e-4)),
        gamma=float(m.get("gamma", 0.95)),
        lr_decay_steps=tuple(int(s) for s in m.get("lr_decay_steps",
                                                   (10, 20))),
        epochs=int(tr.get("max_epochs", 30)),
        patience=int(m.get("patience", 7)),
        seed=seed,
    )


def _make_datasets(mode: str, datasheet: str, datapath: str,
                   norm_type: int, augment: bool):
    if mode == "t2":
        def mk(**kw):
            return T2SliceDataset(datasheet, datapath, norm_type=norm_type,
                                  **kw)
    else:
        def mk(**kw):
            return DWISliceDataset(datasheet, datapath, **kw)
    train = mk(augment=augment, istrain=True, isval=False, istest=False)
    val = mk(istrain=False, isval=True, istest=False)
    test = mk(istrain=False, isval=False, istest=True)
    return train, val, test


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train/evaluate the ConvNeXt PIRADS classifier "
                    "(vendored train_t2.py / train_dwi.py / test.py surface)")
    p.add_argument("--mode", required=True, choices=["t2", "dwi"])
    p.add_argument("--config-file", default=None,
                   help="Vendored-schema YAML (model_args/data/training); "
                        "the YAML wins over the flags, as in the reference "
                        "scripts.")
    p.add_argument("--index-seed", type=int, default=None,
                   help="Seed index (the JAX package's sequence)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--datasheet", default=None,
                   help="CSV with data_split/PIRADS/fastmri_rawfile columns")
    p.add_argument("--data-path", default=None)
    p.add_argument("--out-dir", default="runs/classify")
    p.add_argument("--model", default="tiny", choices=["tiny", "convnext"])
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--scheduler", default="exponentiallr",
                   choices=["exponentiallr", "multistep", "cosine", "plat",
                            "none"])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--lr-decay-steps", type=int, nargs="+", default=[10, 20])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 8; with --config-file the vendored "
                        "DataLoaders' hard-coded 32")
    p.add_argument("--patience", type=int, default=7)
    p.add_argument("--norm-type", type=int, default=2,
                   help="T2 normalisation scheme 1-4 (vendored norm_type)")
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.set_defaults(augment=True)
    p.add_argument("--no-amp", dest="amp", action="store_false")
    p.set_defaults(amp=True)
    p.add_argument("--data-parallel", type=int, default=1,
                   help="ranks to shard each batch over, one card each "
                        "(CPU ranks with --device cpu)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest snapshot in out-dir")
    p.add_argument("--save-resume-every", type=int, default=0,
                   help="epochs between resume snapshots (0 disables)")
    p.add_argument("--resume-keep", type=int, default=0,
                   help="keep only the newest N resume snapshots (0 = all)")
    p.add_argument("--preempt-save", action="store_true",
                   help="SIGTERM/SIGUSR1 -> resume snapshot at the next "
                        "epoch boundary, clean stop; rerun with --resume")
    p.add_argument("--evaluate", default=None, metavar="CKPT",
                   help="Skip training; report loss/AUC of this checkpoint "
                        "on the datasheet's test split (vendored test.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    return p


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = build_parser()
    args = p.parse_args(argv)
    if args.data_parallel < 1:
        p.error(f"--data-parallel {args.data_parallel} is below 1")
    if args.data_parallel > 1:
        devices = mesh_devices(args.data_parallel, args.device)
        result = spawn(_rank_main, args.data_parallel, devices,
                       args=(argv,), timeout_s=1e6)[0]
    else:
        result = _run(p, args, None)
    print(json.dumps(result))
    return 0


def _rank_main(group: DataGroup, argv: list) -> Optional[dict]:
    """One spawned rank of ``--data-parallel``."""
    p = build_parser()
    return _run(p, p.parse_args(argv), group)


def _run(p: argparse.ArgumentParser, args: argparse.Namespace,
         group: Optional[DataGroup]) -> Optional[dict]:
    """Train (or ``--evaluate``) on this process or on ``group``'s rank;
    returns what the CLI prints (None on the ranks after the first)."""
    primary = group is None or group.primary
    seed = (args.seed if args.index_seed is None
            else _seed_for_index(args.index_seed))
    if args.config_file:
        cargs = _args_from_yaml(args.config_file, args.mode, seed)
        cfg = _load_yaml(args.config_file)
        d = cfg.get("data", {})
        datasheet = args.datasheet or d.get("datasheet")
        datapath = args.data_path or d.get("data_location")
        norm_type = int(d.get("norm_type", args.norm_type))
        augment = bool(cfg.get("training", {}).get("augment", args.augment))
        # the YAML picks the model (vendored model.py:23-30); the batch is
        # the vendored DataLoaders' 32 unless the flag was given
        cargs.batch_size = (args.batch_size if args.batch_size is not None
                            else 32)
        cargs.amp = args.amp
        cargs.resume_keep = args.resume_keep
        cargs.data_parallel = args.data_parallel
    else:
        cargs = ClassifierArgs(
            out_dir=args.out_dir, model=args.model, diff=(args.mode == "dwi"),
            optimizer=args.optimizer, scheduler=args.scheduler, lr=args.lr,
            momentum=args.momentum, weight_decay=args.weight_decay,
            gamma=args.gamma, lr_decay_steps=tuple(args.lr_decay_steps),
            epochs=args.epochs,
            batch_size=args.batch_size if args.batch_size is not None else 8,
            patience=args.patience, seed=seed, amp=args.amp,
            resume_keep=args.resume_keep, data_parallel=args.data_parallel)
        datasheet, datapath = args.datasheet, args.data_path
        norm_type, augment = args.norm_type, args.augment
    if not datasheet or not datapath:
        p.error("--datasheet and --data-path are required "
                "(directly or via the YAML's data section)")

    train_ds, val_ds, test_ds = _make_datasets(
        args.mode, datasheet, datapath, norm_type, augment)
    trainer = ClassifierTrainer(cargs, train_ds, val_ds, device=args.device,
                                group=group)

    if args.evaluate:
        metrics = trainer.evaluate(test_ds, ckpt_path=args.evaluate)
        return ({"mode": args.mode, "split": "test", **metrics} if primary
                else None)

    os.makedirs(cargs.out_dir, exist_ok=True)
    if args.config_file and primary:
        # vendored behavior: the exact config rides with the run artifacts
        shutil.copyfile(args.config_file,
                        os.path.join(cargs.out_dir, "params.txt"))
    result = trainer.fit(resume=args.resume,
                         save_resume_every=args.save_resume_every,
                         preempt_save=args.preempt_save)
    test_metrics = trainer.evaluate(test_ds, ckpt_path=result["best_ckpt"])
    if not primary:
        return None
    with open(os.path.join(cargs.out_dir, "test_metrics.json"), "w",
              encoding="utf-8") as f:
        json.dump(test_metrics, f, indent=2)
    return {"best_ckpt": result["best_ckpt"],
            "epochs_ran": len(result["history"]), "test": test_metrics}


if __name__ == "__main__":
    raise SystemExit(main())
