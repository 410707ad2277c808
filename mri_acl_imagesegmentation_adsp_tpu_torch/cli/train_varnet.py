"""Train or test VarNet on prostate DWI ``.h5`` slices.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/train_varnet.py``
(the prostate code's ``train_varnet_prostate.py``): the same flags, the
b-value's slice datasets under ``--data-path`` (``train/``, ``val/``), an
optional prospective mask (``--mask-type``), ``--mode train`` (fit, with
resume snapshots and preemption) or ``--mode test`` (resume, validate and,
with ``--recon-out``, one reconstruction ``.h5`` a test volume), plus
``--device`` (default ``cuda``, which raises without a card). Reading the
slices needs h5py. ``--data-parallel D --coil-parallel C`` above ``1 x 1``
spawns ``D * C`` ranks (``parallel/mesh.py:spawn``, one card each, or CPU
ranks with ``--device cpu``) on a ``(D, C)`` grid (``make_recon_grid``),
each reading the slices and training its block of each batch; rank 0
writes the run. ``--pipeline-parallel N`` spawns ``N`` ranks of a pipe
(``VarNetTrainer(pipe_mesh=)``: the cascades as GPipe stages,
``parallel/pipeline.py``); ``--num-cascades`` must tile ``N``, and it
excludes ``--data-parallel`` / ``--coil-parallel``, as in JAX. Asking for
more ranks than cards raises as JAX's ``make_recon_mesh`` does. Refused, as
the trainer refuses them: ``--ckpt-backend orbax`` and ``--ckpt-async``
(the port's own snapshots take their place).

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.train_varnet \\
      --data-path /data/prostate_dwi --bvalue b50 --out-dir runs/varnet_b50
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Train VarNet (prostate DWI, PyTorch)")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--test-path", type=Path, default=None,
                   help="h5 dir for --mode test (default <data-path>/test, "
                        "falling back to val/)")
    p.add_argument("--recon-out", type=Path, default=None,
                   help="write per-volume reconstruction h5s here in "
                        "--mode test")
    p.add_argument("--mask-type", default="none",
                   choices=["none", "random", "equispaced"],
                   help="prospective undersampling mask_func")
    p.add_argument("--center-fractions", type=float, nargs="+",
                   default=[0.08])
    p.add_argument("--accelerations", type=int, nargs="+", default=[4])
    p.add_argument("--data-path", type=Path, required=True,
                   help="root with train/ and val/ h5 dirs")
    p.add_argument("--out-dir", default="runs/varnet")
    p.add_argument("--bvalue", default="b50", choices=["b50", "b1000"])
    p.add_argument("--num-cascades", type=int, default=12)
    p.add_argument("--pools", type=int, default=4)
    p.add_argument("--chans", type=int, default=18)
    p.add_argument("--sens-pools", type=int, default=4)
    p.add_argument("--sens-chans", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.0003)
    p.add_argument("--lr-step-size", type=int, default=40)
    p.add_argument("--lr-gamma", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=1,
                   help="same-shape samples an optimizer step")
    p.add_argument("--num-workers", type=int, default=0,
                   help="readahead threads over the slice dataset")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-amp", dest="amp", action="store_false")
    p.set_defaults(amp=True)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest snapshot in out-dir")
    p.add_argument("--save-resume-every", type=int, default=1,
                   help="epochs between resume snapshots (0 disables)")
    p.add_argument("--resume-keep", type=int, default=0,
                   help="keep only the newest N resume snapshots (0 = all)")
    p.add_argument("--ckpt-async", action="store_true",
                   help="not ported (orbax's); refused")
    p.add_argument("--preempt-save", action="store_true",
                   help="SIGTERM/SIGUSR1 -> resume snapshot at the next "
                        "epoch boundary, clean stop; rerun with --resume")
    p.add_argument("--ckpt-backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="only the port's own snapshots (msgpack's place)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="ranks on the batch ('data') axis of the grid")
    p.add_argument("--coil-parallel", type=int, default=1,
                   help="ranks on the coil axis of the grid (k-space and "
                        "sensitivity coil shares; one coil sum a cascade)")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="GPipe the cascade chain over N ranks (num-"
                        "cascades must tile N; excludes --data/--coil-"
                        "parallel)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    return p


def _varnet_args(args):
    from ..train.varnet_trainer import VarNetArgs
    return VarNetArgs(
        out_dir=args.out_dir, bvalue=args.bvalue,
        num_cascades=args.num_cascades, pools=args.pools, chans=args.chans,
        sens_pools=args.sens_pools, sens_chans=args.sens_chans, lr=args.lr,
        lr_step_size=args.lr_step_size, lr_gamma=args.lr_gamma,
        weight_decay=args.weight_decay, epochs=args.epochs, seed=args.seed,
        amp=args.amp, batch_size=args.batch_size,
        num_workers=args.num_workers, ckpt_backend=args.ckpt_backend,
        resume_keep=args.resume_keep, ckpt_async=args.ckpt_async)


def main(argv=None) -> int:
    from ..parallel.mesh import mesh_devices, spawn
    from ..train.varnet_trainer import check_pipe, check_varnet_args

    p = build_parser()
    args = p.parse_args(argv)
    if args.pipeline_parallel > 1:
        check_pipe(_varnet_args(args), args.pipeline_parallel,
                   args.data_parallel * args.coil_parallel > 1)
    try:
        check_varnet_args(_varnet_args(args))
    except ValueError as exc:
        p.error(str(exc))
    world = args.data_parallel * args.coil_parallel * args.pipeline_parallel
    if world > 1:
        spawn(run_rank, world, mesh_devices(world, args.device),
              args=(args,), timeout_s=1e6)
        return 0
    return run(args)


def run_rank(group, args) -> int:
    """One spawned rank of ``--data-parallel`` x ``--coil-parallel``, or of
    ``--pipeline-parallel`` (the whole group one pipe)."""
    from ..parallel.mesh import make_recon_grid
    if args.pipeline_parallel > 1:
        return run(args, pipe=group)
    return run(args, make_recon_grid(group, args.data_parallel,
                                     args.coil_parallel))


def run(args, grid=None, pipe=None) -> int:
    """Train or test on the parsed ``args``, on one device or as one rank
    of ``grid`` or of ``pipe``."""
    from ..data.recon_data import SliceDataset
    from ..data.transforms import VarNetDataTransform
    from ..train.varnet_trainer import VarNetTrainer

    device = (grid.device if grid is not None else pipe.device
              if pipe is not None else args.device)
    mask_func = None
    if args.mask_type != "none":
        from ..data.subsample import EquispacedMaskFunc, RandomMaskFunc
        cls = (RandomMaskFunc if args.mask_type == "random"
               else EquispacedMaskFunc)
        mask_func = cls(args.center_fractions, args.accelerations)
    transform = VarNetDataTransform(mask_func=mask_func)
    train_ds = SliceDataset(args.data_path / "train", args.bvalue, transform,
                            device=device)
    val_ds = SliceDataset(args.data_path / "val", args.bvalue, transform,
                          device=device)

    trainer = VarNetTrainer(_varnet_args(args), train_ds=train_ds,
                            val_ds=val_ds, mesh=grid, pipe_mesh=pipe,
                            device=device)
    if args.mode == "train":
        trainer.fit(resume=args.resume,
                    save_resume_every=args.save_resume_every,
                    preempt_save=args.preempt_save)
        return 0
    seed_ds = train_ds if len(train_ds) else val_ds
    if len(seed_ds):
        trainer._init_if_needed(seed_ds[0].kspace, seed_ds[0].espirit)
    trainer.try_resume()
    metrics = trainer.validate()
    if trainer.primary:
        print(metrics)
    test_root = args.test_path or (args.data_path / "test")
    if not Path(test_root).is_dir():
        test_root = args.data_path / "val"
    if args.recon_out is not None:
        test_ds = SliceDataset(Path(test_root), args.bvalue, transform,
                               device=device)
        stacks = trainer.reconstruct(test_ds, out_dir=args.recon_out)
        if trainer.primary:
            print(f"wrote {len(stacks)} reconstruction h5(s) -> "
                  f"{args.recon_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
