"""VarNet reconstruction trainer.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/varnet_trainer.py``
(the prostate code's ``VarNetModule`` and ``MriModule``):

* ``combine_directions`` (:38-49): the geometric mean over the direction
  outputs, b1000's four averages a direction first;
* ``VarNetArgs`` (:52-86): the same fields and defaults;
* ``build_varnet_from_args`` (:89-102): the one construction path, shared
  with serving (``cli/serve.py --task recon``);
* ``VarNetTrainer`` (:105-455): same-shape batches of up to ``batch_size``
  samples, flushed early when a sample's k-space or target shape changes;
  StepLR by epoch; the SSIM loss on the combined output after
  ``center_crop_to_smallest`` and the ``crop``; AdamW without a clip
  (``train/optim.py``); ``validate`` with the per-volume aggregation and
  the slice dedup of ``MriModule`` (a later duplicate of a (volume, slice)
  replaces the earlier one); ``reconstruct`` with its per-volume ``.h5``
  export; the best checkpoint by validation loss in the port's format
  (``varnet_best.ckpt`` + ``.args.json``); resume snapshots,
  ``try_resume`` and preemption.

The model is built, and its weights drawn from a CPU generator seeded with
``args.seed``, at the first sample, whose k-space gives the averages
(``aves``) and whose ESPIRiT maps give ``sens_aves``, as the JAX trainer
initializes Flax on its first batch. An f32 model (``amp`` off) computes in
f32 on a card, TF32 off (``utils/device.py:f32_on_card``), as the committed
f32 reference run computed on the CPU. The losses stay on the device and
are read once an epoch; ``validate`` reads its metrics once too.

``mesh``: a ``parallel/mesh.py:ReconGrid``, this rank's place on a ``(data,
coil)`` grid of ranks (JAX ``_init_if_needed`` / ``_place_batch``,
:109-185). The weights are replicated (every rank draws them from the one
seed); every rank reads the same samples in the same order, so the ranks
agree on each global batch, of which the model keeps the rank's block
(``recon/varnet.py``) and the loss the rank's rows. The gradients and the
loss are then averaged over the whole grid (``grid_average``: the coil
ranks' gradients are each that of the sum of their losses), so every
rank takes the same step. ``validate`` and ``reconstruct`` run on the grid
too: a sample is a batch of one, whole on every data rank and split over
the coil ranks. Rank 0 writes the run's files.

``pipe_mesh``: a ``parallel/mesh.py:DataGroup`` of pipe ranks (JAX
:109-134, :195-201): the cascades run as GPipe stages over its ranks
(``parallel/pipeline.py:varnet_apply_pipelined``), one microbatch a sample
of the batch, as JAX runs them; the sensitivity model and the final
combine run on every rank. Every rank holds the whole model, reads the
same samples and computes the same loss; the gradients are averaged over
the pipe ranks (the pipeline's rule, ``parallel/pipeline.py``), so every
rank takes the same step. ``validate`` and ``reconstruct`` run pipelined
too, and rank 0 writes. ``num_cascades`` must tile the pipe, and ``mesh``
and ``pipe_mesh`` exclude each other, as in JAX.

Refused, naming what stands in: ``ckpt_backend="orbax"`` and
``ckpt_async`` (JAX libraries; the port's own snapshots,
``train/checkpoint.py``, take their place).
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass, fields as dc_fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.prefetch import prefetch
from ..data.transforms import center_crop, center_crop_to_smallest
from ..models.fastmri_unet import init_fastmri_weights
from ..parallel.mesh import (DataGroup, ReconGrid, any_rank, average_flat,
                             barrier, grid_average, row_slice)
from ..parallel.pipeline import pipeline_grads, varnet_apply_pipelined
from ..recon.varnet import VarNet
from ..utils.device import f32_on_card, resolve_device, upload
from . import checkpoint as ckpt_lib
from .optim import ClippedAdamW
from .ssim import ssim_loss
from .trainer import _preempt_signals
from .trainer3d import _mean_of

# the k-space averages of a DWI b-value's slices (data/recon_data.py)
BVALUE_AVES = {"b50": 3, "b1000": 12}


def combine_directions(output: torch.Tensor) -> torch.Tensor:
    """Geometric mean over direction outputs ``(b, A, h, w)`` -> ``(b, h,
    w)``; at ``A == 12`` (b1000) each direction's 4 averages are averaged
    first."""
    if output.shape[1] == 12:
        x = torch.sum(output[:, [0, 3, 6, 9]], 1) / 4
        y = torch.sum(output[:, [1, 4, 7, 10]], 1) / 4
        z = torch.sum(output[:, [2, 5, 8, 11]], 1) / 4
        return torch.pow(x * y * z, 1.0 / 3.0)   # magnitudes: >= 0
    return torch.pow(torch.prod(output, 1), 1.0 / output.shape[1])


@dataclass
class VarNetArgs:
    data_root: str = ""
    val_root: str = ""
    out_dir: str = "runs/varnet"
    bvalue: str = "b50"
    num_cascades: int = 12
    pools: int = 4
    chans: int = 18
    sens_pools: int = 4
    sens_chans: int = 8
    lr: float = 3e-4
    lr_step_size: int = 40
    lr_gamma: float = 0.1
    weight_decay: float = 0.0
    epochs: int = 50
    crop: int = 100
    seed: int = 42
    amp: bool = True
    batch_size: int = 1      # same-shape samples an optimizer step
    num_workers: int = 0     # readahead threads (data/prefetch.py)
    ckpt_backend: str = "msgpack"   # the port's own snapshot format
    resume_keep: int = 0     # keep the newest N snapshots (0 = all)
    ckpt_async: bool = False


def build_varnet_from_args(a, aves: Optional[int] = None, sens_aves: int = 1,
                           mesh=None) -> VarNet:
    """The one VarNet construction path, shared by training and serving.

    ``a`` is a :class:`VarNetArgs` or a saved args dict
    (``varnet_best.ckpt.args.json``); fields it lacks take the defaults and
    fields it has beyond them are ignored. ``aves`` (the k-space's averages)
    defaults to the b-value's (b50: 3, b1000: 12); another b-value must name
    it. ``sens_aves`` is the ESPIRiT maps' averages (1 from the per-slice
    dataset). ``mesh``: a ``ReconGrid`` for the coil-parallel layout
    (``recon/varnet.py``)."""
    if mesh is not None and not isinstance(mesh, ReconGrid):
        raise TypeError(f"mesh must be a parallel.mesh.ReconGrid, got "
                        f"{type(mesh).__name__}")
    if not isinstance(a, VarNetArgs):
        known = {f.name for f in dc_fields(VarNetArgs)}
        a = VarNetArgs(**{k: v for k, v in dict(a).items() if k in known})
    if aves is None:
        if a.bvalue not in BVALUE_AVES:
            raise ValueError(f"bvalue {a.bvalue!r} does not fix the k-space "
                             "averages; pass aves")
        aves = BVALUE_AVES[a.bvalue]
    return VarNet(aves=aves, sens_aves=sens_aves,
                  num_cascades=a.num_cascades, sens_chans=a.sens_chans,
                  sens_pools=a.sens_pools, chans=a.chans, pools=a.pools,
                  dtype=torch.bfloat16 if a.amp else torch.float32,
                  mesh=mesh)


def check_pipe(args: VarNetArgs, n_pipe: int, with_mesh: bool) -> None:
    """JAX's pipe checks: a pipe excludes a ``(data, coil)`` mesh, and the
    cascades must tile its ``n_pipe`` ranks."""
    if with_mesh:
        raise ValueError("mesh (DP x coil-TP) and pipe_mesh (cascade PP) "
                         "are mutually exclusive")
    if args.num_cascades % n_pipe:
        raise ValueError(f"{args.num_cascades} cascades do not tile a "
                         f"{n_pipe}-way pipe axis")


def check_varnet_args(args: VarNetArgs, mesh=None, pipe_mesh=None) -> None:
    """Raise ``ValueError`` naming what the port cannot run, or what a
    pipe cannot hold."""
    if mesh is not None and not isinstance(mesh, ReconGrid):
        raise TypeError(f"mesh must be a parallel.mesh.ReconGrid, got "
                        f"{type(mesh).__name__}")
    if pipe_mesh is not None:
        if not isinstance(pipe_mesh, DataGroup):
            raise TypeError(f"pipe_mesh must be a parallel.mesh.DataGroup, "
                            f"got {type(pipe_mesh).__name__}")
        check_pipe(args, pipe_mesh.world, mesh is not None)
    if args.ckpt_backend != "msgpack":
        raise ValueError(f"ckpt_backend {args.ckpt_backend!r} is not "
                         "ported: orbax is a JAX library; the port's own "
                         "snapshots (train/checkpoint.py) take its place")
    if args.ckpt_async:
        raise ValueError("ckpt_async is not ported: it is orbax's; the "
                         "port's own snapshots (train/checkpoint.py) are "
                         "written synchronously")


def crop_pair(target: torch.Tensor, out: torch.Tensor, crop: int):
    """``center_crop_to_smallest``, then both to ``crop`` (or less) square
    around the centre."""
    target, out = center_crop_to_smallest(target, out)
    ch, cw = min(crop, target.shape[-2]), min(crop, target.shape[-1])
    return center_crop(target, (ch, cw)), center_crop(out, (ch, cw))


def varnet_loss(model: VarNet, kspace, espirit, target, max_value,
                crop: int) -> torch.Tensor:
    """The training loss: ``1 - SSIM`` of the direction-combined output
    (``model(kspace, espirit)``, the model or a pipelined forward)
    against the target, both cropped by :func:`crop_pair`."""
    target, out = crop_pair(target, combine_directions(model(kspace,
                                                             espirit)), crop)
    return ssim_loss(out[:, None], target[:, None], max_value)


def _no_mark(stage: str) -> None:
    pass


class VarNetTrainer:
    """``VarNetTrainer(args, train_ds, val_ds, device=...).fit()``; the
    datasets are indexable sequences of ``VarNetSample``. With ``mesh`` (a
    ``ReconGrid``), one rank of a grid run on ``mesh.device``; with
    ``pipe_mesh`` (a ``DataGroup``), one rank of a pipe."""

    def __init__(self, args: VarNetArgs, train_ds=None, val_ds=None,
                 mesh: Optional[ReconGrid] = None, pipe_mesh=None,
                 device: str | torch.device = "cuda"):
        check_varnet_args(args, mesh, pipe_mesh)
        self.args = args
        self.mesh = mesh
        self.pipe = pipe_mesh
        self.group = mesh.world if mesh is not None else pipe_mesh
        self.primary = self.group is None or self.group.primary
        self.device = (self.group.device if self.group is not None
                       else resolve_device(device))
        os.makedirs(args.out_dir, exist_ok=True)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.model: Optional[VarNet] = None
        self.optimizer: Optional[ClippedAdamW] = None
        self.epoch = 0
        self.best_val = float("inf")
        self._preempt = False
        self.best_path = os.path.join(args.out_dir, "varnet_best.ckpt")

    # ------------------------------------------------------------------

    def _init_if_needed(self, kspace: np.ndarray, espirit: np.ndarray
                        ) -> None:
        """Build the model for one sample's ``(coils, aves, h, w, 2)``
        k-space and maps (or a batch of them)."""
        if self.model is not None:
            return
        k, e = np.shape(kspace), np.shape(espirit)
        model = build_varnet_from_args(self.args, aves=int(k[-4]),
                                       sens_aves=int(e[-4]), mesh=self.mesh)
        init_fastmri_weights(model,
                             torch.Generator().manual_seed(self.args.seed))
        self.model = model.to(self.device)
        self.optimizer = ClippedAdamW(self.model.parameters(), self.args.lr,
                                      self.args.weight_decay, 0.0)

    def _lr_now(self) -> float:
        decays = self.epoch // self.args.lr_step_size
        return self.args.lr * (self.args.lr_gamma ** decays)

    def _forward(self, kspace: torch.Tensor, espirit: torch.Tensor
                 ) -> torch.Tensor:
        """The model's ``|image|``, its cascades pipelined on a pipe (one
        microbatch a sample)."""
        if self.pipe is None:
            return self.model(kspace, espirit)
        return varnet_apply_pipelined(self.model, kspace, espirit, self.pipe,
                                      n_microbatches=int(kspace.shape[0]))

    def upload_batch(self, batch) -> tuple:
        """A list of same-shape samples as device tensors ``(kspace,
        espirit, target, max_value)``."""
        dev = self.device
        return (upload(np.stack([s.kspace for s in batch]), dev),
                upload(np.stack([s.espirit for s in batch]), dev),
                upload(np.stack([s.target for s in batch]), dev),
                torch.tensor([s.max_value for s in batch],
                             dtype=torch.float32).to(dev))

    def loss_and_grads(self, kspace, espirit, target, max_value,
                       mark=_no_mark) -> tuple:
        """The training loss (a device scalar) and its gradients, in the
        optimizer's parameter order; ``mark`` is called after the forward
        and loss (``"forward_loss"``) and after the backward
        (``"backward"``). On a grid, of the global batch: averaged over
        every rank (``grid_average``), equal on every rank; on a pipe,
        averaged over its ranks (``parallel/pipeline.py``)."""
        self.model.train()
        if self.mesh is not None:
            rows = row_slice(int(target.shape[0]), self.mesh.data)
            if rows is not None:
                target, max_value = target[rows], max_value[rows]
        with f32_on_card(self.device):
            loss = varnet_loss(self._forward, kspace, espirit, target,
                               max_value, self.args.crop)
            mark("forward_loss")
            if self.pipe is not None:
                grads = pipeline_grads(loss, self.optimizer.params)
                *grads, loss = average_flat(grads + [loss.detach()],
                                            self.pipe)
            else:
                grads = torch.autograd.grad(loss, self.optimizer.params)
            if self.mesh is not None:
                *grads, loss = grid_average(list(grads) + [loss.detach()],
                                            self.mesh)
            mark("backward")
        return loss.detach(), grads

    def _step_batch(self, batch, mark=_no_mark) -> torch.Tensor:
        """One optimizer step on a list of same-shape samples; returns the
        loss as a device scalar (no host read). ``mark(stage)`` is called
        at the end of each stage: ``upload``, those of
        :meth:`loss_and_grads`, ``optimizer`` (``tools/probe_varnet_step.py``
        synchronizes and reads the clock there)."""
        self._init_if_needed(batch[0].kspace, batch[0].espirit)
        tensors = self.upload_batch(batch)
        mark("upload")
        loss, grads = self.loss_and_grads(*tensors, mark=mark)
        self.optimizer.lr = self._lr_now()
        self.optimizer.step(grads)
        mark("optimizer")
        return loss

    def train_one_epoch(self) -> float:
        bs = max(1, int(self.args.batch_size))
        losses: List[torch.Tensor] = []
        batch: list = []
        for sample in prefetch(self.train_ds, int(self.args.num_workers)):
            if batch and (len(batch) >= bs
                          or sample.kspace.shape != batch[0].kspace.shape
                          or sample.target.shape != batch[0].target.shape):
                losses.append(self._step_batch(batch))
                batch = []
            batch.append(sample)
        if batch:
            losses.append(self._step_batch(batch))
        return _mean_of(losses)

    @torch.no_grad()
    def _sample_out(self, sample) -> torch.Tensor:
        """The combined output ``(h, w)`` of one sample, on the device."""
        self._init_if_needed(sample.kspace, sample.espirit)
        self.model.eval()
        k = upload(sample.kspace[None], self.device)
        e = upload(sample.espirit[None], self.device)
        with f32_on_card(self.device):
            return combine_directions(self._forward(k, e))[0]

    @torch.no_grad()
    def validate(self) -> Dict[str, float]:
        """``MriModule``'s aggregation: per (volume, slice) the MSE, the
        target's mean square and the SSIM (a duplicate slice replaces the
        earlier), then per volume NMSE, PSNR and mean SSIM, averaged over
        volumes; the validation loss is the mean SSIM loss over samples."""
        from ..metrics.recon_eval import _ssim_2d
        losses: List[torch.Tensor] = []
        per_slice: Dict[tuple, torch.Tensor] = {}   # (mse, tnorm, ssim)
        max_vals: Dict[str, float] = {}
        for sample in prefetch(self.val_ds, int(self.args.num_workers)):
            out = self._sample_out(sample)
            target = upload(np.asarray(sample.target, np.float32),
                             self.device)
            target, out = crop_pair(target, out, self.args.crop)
            mv = float(sample.max_value)
            losses.append(ssim_loss(out[None, None], target[None, None],
                                    torch.tensor([mv], device=self.device)))
            per_slice[(str(sample.fname), int(sample.slice_num))] = (
                torch.stack([torch.mean((target - out) ** 2),
                             torch.mean(target * target),
                             _ssim_2d(target, out, mv)]))
            max_vals[str(sample.fname)] = mv

        keys = list(per_slice)
        vals = (torch.stack([per_slice[k] for k in keys]).cpu().tolist()
                if keys else [])
        by_vol: Dict[str, list] = {}
        for (f, _), v in zip(keys, vals):
            by_vol.setdefault(f, []).append(v)
        metrics = {"nmse": 0.0, "ssim": 0.0, "psnr": 0.0}
        for f, rows in by_vol.items():
            mse_val = float(np.mean([r[0] for r in rows]))
            tnorm = float(np.mean([r[1] for r in rows]))
            metrics["nmse"] += mse_val / tnorm
            metrics["psnr"] += float(20 * np.log10(max_vals[f])
                                     - 10 * np.log10(mse_val))
            metrics["ssim"] += float(np.mean([r[2] for r in rows]))
        for m in metrics:
            metrics[m] /= max(1, len(by_vol))
        metrics["validation_loss"] = _mean_of(losses)
        return metrics

    @torch.no_grad()
    def reconstruct(self, ds, out_dir=None) -> Dict[str, np.ndarray]:
        """Test-time reconstruction: each volume's slices stacked in slice
        order (a duplicate slice replaces the earlier); with ``out_dir``
        one ``<fname>`` ``.h5`` a volume holding ``reconstruction`` (the
        prostate code's ``save_recon``), written by rank 0 of a grid."""
        by_vol: Dict[str, Dict[int, torch.Tensor]] = {}
        for sample in ds:
            by_vol.setdefault(str(sample.fname), {})[
                int(sample.slice_num)] = self._sample_out(sample)
        stacks = {f: torch.stack([sl[i] for i in sorted(sl)]).cpu().numpy()
                  for f, sl in by_vol.items()}
        if out_dir is not None and self.primary:
            from ..data.recon_data import save_recon
            os.makedirs(out_dir, exist_ok=True)
            for f, vol in stacks.items():
                save_recon({"reconstruction": vol}, os.path.join(out_dir, f))
        return stacks

    # ------------------------------------------------------------------

    def _save_best(self) -> None:
        if self.primary:
            ckpt_lib.save_best(self.best_path, self.model.state_dict(),
                               asdict(self.args))

    def _save_resume(self, epoch: int) -> None:
        tensors = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict()}
        host = {"epoch": int(epoch), "best_val": float(self.best_val)}
        if self.primary:
            ckpt_lib.save_resume(self.args.out_dir, epoch, tensors, host,
                                 keep=self.args.resume_keep)
        barrier(self.group)

    def try_resume(self) -> bool:
        """Restore the newest snapshot in ``out_dir``; the model must be
        built (after the first ``_init_if_needed``)."""
        d = ckpt_lib.latest_resume_dir(self.args.out_dir)
        if d is None or self.model is None:
            return False
        tensors, host = ckpt_lib.load_train_state(d, self.device)
        self.model.load_state_dict(tensors["model"])
        self.optimizer.load_state_dict(tensors["optimizer"])
        self.epoch = int(host["epoch"])
        self.best_val = float(host["best_val"])
        print(f"[varnet] resumed {d} at epoch {self.epoch}")
        return True

    def request_preempt(self) -> None:
        """Snapshot at the next epoch boundary and stop (the SIGTERM /
        SIGUSR1 handler under ``preempt_save``)."""
        self._preempt = True

    def fit(self, resume: bool = False, save_resume_every: int = 0,
            preempt_save: bool = False) -> Dict[str, Any]:
        with _preempt_signals(preempt_save, self.request_preempt):
            return self._fit(resume, save_resume_every)

    def _fit(self, resume: bool, save_resume_every: int) -> Dict[str, Any]:
        if resume:
            seed_ds = self.train_ds if self.train_ds else self.val_ds
            if not seed_ds:
                raise ValueError(
                    "resume=True but both datasets are empty: refusing to "
                    "run (a fresh random model would overwrite the best "
                    "checkpoint)")
            s0 = seed_ds[0]
            self._init_if_needed(s0.kspace, s0.espirit)
            if not self.try_resume():
                print("[varnet] resume requested but no snapshot found in "
                      f"{self.args.out_dir}; starting fresh")
        history = []
        for ep in range(self.epoch + 1, self.args.epochs + 1):
            self.epoch = ep
            t0 = time.time()
            tr = self.train_one_epoch()
            val = self.validate()
            vl = val["validation_loss"]
            if self.primary:
                print(f"[varnet] epoch {ep:03d} train {tr:.4f} val "
                      f"{vl:.4f} nmse {val['nmse']:.4f} ssim "
                      f"{val['ssim']:.4f} psnr {val['psnr']:.2f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            history.append({"epoch": ep, "train_loss": tr, **val,
                            "seconds": time.time() - t0})
            if vl < self.best_val:
                self.best_val = vl
                self._save_best()
            if save_resume_every and ep % save_resume_every == 0:
                self._save_resume(ep)
            self._preempt = any_rank(self._preempt, self.group)
            if self._preempt:
                if not (save_resume_every and ep % save_resume_every == 0):
                    self._save_resume(ep)
                print(f"[preempt] resume snapshot saved (epoch {ep} done);"
                      " stopping")
                break
        barrier(self.group)
        return {"best_ckpt": self.best_path, "history": history}
