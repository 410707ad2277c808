"""VarNet trained on synthetic multi-coil phantoms made in memory.

Counterparts: ``scripts/train_varnet_synthetic.py`` and
``scripts/train_varnet_protocol.py``, whose data code is copied here as it
is (numpy only), so one seed gives their arrays bit for bit: smooth
multi-ellipse phantoms, smooth complex coil sensitivities normalized to RSS
1, equispaced masks with a fully sampled centre (``data/subsample.py``), and
``VarNetSample``s with k-space ``(coils, 1, h, w, 2)`` and maps ``(coils, 1,
h, w, 2)``. Two recipes, the arguments of the JAX runs' committed
``varnet_best.ckpt.args.json``:

* ``synthetic`` (``runs/varnet_synthetic``): 96x96, 4 coils, R=6 with a
  6 % centre; 4 cascades, ``chans`` 8, ``sens_chans`` 4, 3 pools, f32, lr
  1e-3, crop 64; 30 epochs of 48 slices (6 volumes of 8), validated on 8;
* ``protocol`` (``runs/varnet_protocol_steps``): 320x320, 12 coils, R=4
  with an 8 % centre; 10 cascades, ``chans`` 20, ``sens_chans`` 8, 4 pools,
  bf16, lr 1e-3, crop 100; 13 epochs of 24 slices, validated on 4.

``run(recipe, device, seed=...)`` trains
``train/varnet_trainer.py:VarNetTrainer`` (``seed`` draws its weights;
the JAX runs' is 42) and returns the history, the validation NMSE / SSIM
/ PSNR of the last epoch and of ``varnet_best.ckpt`` (best by validation
loss), and the zero-filled SENSE-adjoint baseline's on the same validation
slices (the synthetic script's ``eval_baseline``; the protocol script has
none, so the same baseline is computed for it). Beside each NMSE stands
the NMSE at the best intensity gain a slice (``nmse_gain_fitted``, with
the mean gain): the SSIM loss scarcely weighs a global intensity scale
(its luminance term moves by the square of a small scale error), so an
NMSE or PSNR that swings between epochs while the SSIM holds is a scale
error when the gain-fitted NMSE stays low. The quality bounds are the JAX runs'
minus a margin, for one seed with another random stream: the synthetic
recipe beats zero-filled on SSIM and NMSE and reaches val SSIM 0.80, the
protocol recipe val SSIM 0.88. This is how VarNet trains on a machine
without h5py: like ``tools/make_corpus.py``, it feeds the trainer in memory.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.varnet_synthetic \\
      --recipe synthetic --out-dir runs_port/varnet_synthetic [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.subsample import EquispacedMaskFunc, apply_mask
from ..data.transforms import VarNetSample, center_crop
from ..metrics.recon_eval import nmse, psnr, ssim
from ..train import checkpoint as ckpt_lib
from ..train.varnet_trainer import VarNetArgs, VarNetTrainer, crop_pair

RECIPES: Dict[str, dict] = {
    "synthetic": dict(
        size=96, coils=4, center_fraction=0.06, acceleration=6,
        ellipses=(3, 6), train=dict(n_vols=6, slices=8, seed=7, tag="train"),
        val=dict(n_vols=1, slices=8, seed=99, tag="val"),
        args=dict(num_cascades=4, chans=8, sens_chans=4, pools=3,
                  sens_pools=3, lr=1e-3, epochs=30, crop=64, amp=False,
                  bvalue="custom"),
        bounds=dict(ssim=0.80, beat_zero_filled=True)),
    "protocol": dict(
        size=320, coils=12, center_fraction=0.08, acceleration=4,
        ellipses=(4, 8), train=dict(n=24, seed=21, tag="tr"),
        val=dict(n=4, seed=77, tag="va"),
        args=dict(num_cascades=10, pools=4, chans=20, sens_pools=4,
                  sens_chans=8, lr=1e-3, lr_step_size=40, lr_gamma=0.1,
                  weight_decay=0.0, epochs=13, crop=100, amp=True,
                  bvalue="protocol-synthetic"),
        bounds=dict(ssim=0.88, beat_zero_filled=False)),
}


def _fft2c(img2d: np.ndarray) -> np.ndarray:
    x = np.fft.ifftshift(img2d, axes=(-2, -1))
    x = np.fft.fft2(x, norm="ortho")
    return np.fft.fftshift(x, axes=(-2, -1))


def _ifft2c(ksp: np.ndarray) -> np.ndarray:
    x = np.fft.ifftshift(ksp, axes=(-2, -1))
    x = np.fft.ifft2(x, norm="ortho")
    return np.fft.fftshift(x, axes=(-2, -1))


def sens_maps(recipe: str) -> np.ndarray:
    """Smooth complex coil sensitivities ``(coils, H, W)``, RSS 1: the four
    corners (synthetic) or a ring of 12 (protocol)."""
    r = RECIPES[recipe]
    H = W = r["size"]
    yy, xx = np.mgrid[:H, :W].astype(np.float32) / H
    maps = []
    if recipe == "synthetic":
        centers = [(0.2, 0.2), (0.2, 0.8), (0.8, 0.2), (0.8, 0.8)]
        for c, (cy, cx) in enumerate(centers[:r["coils"]]):
            mag = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.35))
            phase = 2.0 * np.pi * (0.1 * c + 0.2 * (xx - cx)
                                   + 0.15 * (yy - cy))
            maps.append(mag * np.exp(1j * phase))
    else:
        coils = r["coils"]
        for c in range(coils):
            ang = 2 * np.pi * c / coils
            cy, cx = 0.5 + 0.45 * np.sin(ang), 0.5 + 0.45 * np.cos(ang)
            mag = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.3))
            phase = 2.0 * np.pi * (0.07 * c + 0.2 * (xx - cx)
                                   + 0.15 * (yy - cy))
            maps.append(mag * np.exp(1j * phase))
    m = np.stack(maps).astype(np.complex64)
    rss = np.sqrt(np.sum(np.abs(m) ** 2, axis=0, keepdims=True))
    return (m / np.maximum(rss, 1e-6)).astype(np.complex64)


def phantom(recipe: str, rng: np.random.Generator) -> np.ndarray:
    """A random smooth multi-ellipse phantom in [0, 1], low-passed so that
    its k-space energy is concentrated (MRI-like)."""
    r = RECIPES[recipe]
    H = W = r["size"]
    yy, xx = np.mgrid[:H, :W].astype(np.float32) / H
    img = np.zeros((H, W), np.float32)
    for _ in range(rng.integers(*r["ellipses"])):
        cy, cx = rng.uniform(0.25, 0.75, 2)
        ry, rx = rng.uniform(0.05, 0.25, 2)
        th = rng.uniform(0, np.pi)
        y, x = yy - cy, xx - cx
        u = np.cos(th) * x + np.sin(th) * y
        v = -np.sin(th) * x + np.cos(th) * y
        img += rng.uniform(0.3, 1.0) * ((u / rx) ** 2 + (v / ry) ** 2 < 1.0)
    img = np.clip(img, 0, 1.6) / 1.6
    k = _fft2c(img)
    fy = np.fft.fftshift(np.fft.fftfreq(H))[:, None]
    fx = np.fft.fftshift(np.fft.fftfreq(W))[None, :]
    k *= np.exp(-((fy ** 2 + fx ** 2) / (2 * 0.12 ** 2)))
    return np.abs(_ifft2c(k)).astype(np.float32)


def make_samples(recipe: str, split: str
                 ) -> Tuple[List[VarNetSample], List[np.ndarray]]:
    """The recipe's ``train`` or ``val`` samples, and the zero-filled
    SENSE-adjoint image of each (the baseline)."""
    r = RECIPES[recipe]
    spec = r[split]
    rng = np.random.default_rng(spec["seed"])
    mask_func = EquispacedMaskFunc(center_fractions=[r["center_fraction"]],
                                   accelerations=[r["acceleration"]])
    sens = sens_maps(recipe)
    sens_pair = np.stack([sens.real, sens.imag], -1).astype(np.float32)
    if recipe == "synthetic":
        # volumes of slices; every slice of a volume gets its mask
        items = [(f"{spec['tag']}_vol{v}", s, 1000 + v)
                 for v in range(spec["n_vols"]) for s in range(spec["slices"])]
    else:
        items = [(f"{spec['tag']}{s:03d}", 0, 1000 + s)
                 for s in range(spec["n"])]
    samples, baselines = [], []
    for fname, slice_num, mask_seed in items:
        img = phantom(recipe, rng)
        ksp = _fft2c(sens * img[None])                       # (C, H, W)
        pair = np.stack([ksp.real, ksp.imag], -1).astype(np.float32)
        masked, _ = apply_mask(pair, mask_func, seed=mask_seed)
        mc = masked[..., 0] + 1j * masked[..., 1]
        zf = np.abs(np.sum(np.conj(sens) * _ifft2c(mc), axis=0))
        samples.append(VarNetSample(
            kspace=masked[:, None].astype(np.float32),       # (C, 1, H, W, 2)
            target=img,
            espirit=sens_pair[:, None],
            fname=fname,
            slice_num=slice_num,
            max_value=float(img.max()),
            crop_size=(r["size"], r["size"])))
        baselines.append(zf.astype(np.float32))
    return samples, baselines


def gain_fitted(pairs) -> Dict[str, float]:
    """The mean over ``(target, prediction)`` pairs of the NMSE after the
    prediction is scaled by the gain that minimizes it, and the mean gain
    (1 where the intensity is right)."""
    gains, errs = [], []
    for tgt, pred in pairs:
        t, p = (np.asarray(a, np.float64).ravel() for a in (tgt, pred))
        g = float(p @ t / max(p @ p, 1e-30))
        gains.append(g)
        errs.append(float(np.sum((g * p - t) ** 2) / np.sum(t ** 2)))
    return {"nmse_gain_fitted": float(np.mean(errs)),
            "gain": float(np.mean(gains))}


def eval_baseline(samples, baselines, crop: int) -> Dict[str, float]:
    """NMSE / SSIM / PSNR of the zero-filled images on the centre crop, the
    mean over slices (the synthetic script's ``eval_baseline``), and
    :func:`gain_fitted` of them."""
    out: Dict[str, list] = {"nmse": [], "ssim": [], "psnr": []}
    pairs = []
    for sample, zf in zip(samples, baselines):
        tgt = center_crop(sample.target, (crop, crop))[None]
        pred = center_crop(zf, (crop, crop))[None]
        pairs.append((tgt, pred))
        out["nmse"].append(nmse(tgt, pred))
        out["ssim"].append(ssim(tgt, pred, maxval=sample.max_value))
        out["psnr"].append(psnr(tgt, pred, maxval=sample.max_value))
    return {**{k: float(np.mean(v)) for k, v in out.items()},
            **gain_fitted(pairs)}


def eval_model(trainer: VarNetTrainer) -> Dict[str, float]:
    """``trainer.validate()`` of its current weights, and
    :func:`gain_fitted` of its outputs on the same crops."""
    import torch
    pairs = []
    for sample in trainer.val_ds:
        out = trainer._sample_out(sample)
        tgt = torch.from_numpy(np.asarray(sample.target, np.float32))
        tgt, out = crop_pair(tgt, out.cpu(), trainer.args.crop)
        pairs.append((tgt.numpy(), out.numpy()))
    return {**trainer.validate(), **gain_fitted(pairs)}


DWI_HDR = """<?xml version="1.0"?>
<ismrmrdHeader xmlns="http://www.ismrm.org/ISMRMRD">
  <encoding>
    <encodedSpace><matrixSize><x>{ro}</x><y>{pe}</y><z>1</z></matrixSize>
    </encodedSpace>
    <reconSpace><matrixSize><x>{ro}</x><y>{pe}</y><z>1</z></matrixSize>
    </reconSpace>
    <encodingLimits><kspace_encoding_step_1><minimum>0</minimum>
      <maximum>{pe_max}</maximum><center>{pe_center}</center>
    </kspace_encoding_step_1></encodingLimits>
    <trajectoryDescription>
      <userParameterLong><name>rampUpTime</name><value>100</value>
      </userParameterLong>
      <userParameterLong><name>rampDownTime</name><value>100</value>
      </userParameterLong>
      <userParameterLong><name>flatTopTime</name><value>400</value>
      </userParameterLong>
      <userParameterLong><name>acqDelayTime</name><value>10</value>
      </userParameterLong>
      <userParameterLong><name>echoSpacing</name><value>1</value>
      </userParameterLong>
    </trajectoryDescription>
  </encoding>
</ismrmrdHeader>"""


def write_dwi_h5(path: str, seed: int, slices: int = 2, coils: int = 2,
                 pe: int = 16, averages: int = 26) -> None:
    """A small fastMRI-prostate DWI case file for ``SliceDataset``: the
    ISMRMRD header (sizes, phase-encode limits, EPI ramp timing),
    ``kspace`` ``(averages, slices, coils, 200, pe)`` (the regridding's 200
    readout samples; 26 averages cover b1000's), ``coil_sens_maps``
    ``(slices, coils, 200, pe)``, ``trace_b50`` / ``trace_b1000`` ``(slices,
    200, pe)`` and the ``max`` attribute; seeded. Needs h5py."""
    from ..native import import_h5py
    h5py = import_h5py("writing a DWI case file")
    rng = np.random.default_rng(seed)
    ro = 200

    def cplx(shape, scale):
        return (scale * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
                ).astype(np.complex64)
    k = cplx((averages, slices, coils, ro, pe), 0.1)
    k[..., 1::3] = 0                    # unsampled phase-encode lines
    with h5py.File(path, "w") as hf:
        hf.create_dataset("ismrmrd_header", data=DWI_HDR.format(
            ro=ro, pe=pe, pe_max=pe - 1, pe_center=pe // 2))
        hf.create_dataset("kspace", data=k, chunks=(1, 1, coils, ro, pe),
                          compression="gzip")
        hf.create_dataset("coil_sens_maps", data=cplx(
            (slices, coils, ro, pe), 1.0))
        for key in ("trace_b50", "trace_b1000"):
            hf.create_dataset(key, data=rng.random(
                (slices, ro, pe)).astype(np.float32))
        hf.attrs["max"] = 1.0


def run(recipe: str, device: str = "cuda", out_dir: Optional[str] = None,
        epochs: Optional[int] = None, seed: Optional[int] = None,
        amp: Optional[bool] = None) -> dict:
    """Train the recipe on ``device`` (``epochs`` cuts its depth; ``seed``
    draws the weights, default ``VarNetArgs``' 42; ``amp`` overrides the
    recipe's compute dtype: False computes in f32, TF32 off) and return
    its summary;
    ``out_dir`` (default a ``varnet_<recipe>`` dir in the working
    directory) receives the checkpoints, ``history.json`` and
    ``summary.json``."""
    r = RECIPES[recipe]
    out_dir = out_dir or f"varnet_{recipe}"
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    train_ds, _ = make_samples(recipe, "train")
    val_ds, val_zf = make_samples(recipe, "val")
    args = VarNetArgs(out_dir=out_dir, **r["args"])
    if epochs is not None:
        args.epochs = int(epochs)
    if seed is not None:
        args.seed = int(seed)
    if amp is not None:
        args.amp = bool(amp)
    base = eval_baseline(val_ds, val_zf, args.crop)
    data_s = time.time() - t0
    trainer = VarNetTrainer(args, train_ds, val_ds, device=device)
    t0 = time.time()
    hist = trainer.fit()["history"]
    wall = time.time() - t0
    final = eval_model(trainer)
    trainer.model.load_state_dict(ckpt_lib.load_best(trainer.best_path))
    best = eval_model(trainer)
    b = r["bounds"]
    bounds = {f"val_ssim>={b['ssim']}": final["ssim"] >= b["ssim"]}
    if b["beat_zero_filled"]:
        bounds["beats_zero_filled_ssim"] = final["ssim"] > base["ssim"]
        bounds["beats_zero_filled_nmse"] = final["nmse"] < base["nmse"]
    summary = {
        "recipe": recipe, "device": str(trainer.device), "seed": args.seed,
        "config": {"size": r["size"], "coils": r["coils"],
                   "accel": r["acceleration"], "train_slices": len(train_ds),
                   "val_slices": len(val_ds), **{
                       k: getattr(args, k) for k in (
                           "num_cascades", "chans", "sens_chans", "pools",
                           "sens_pools", "crop", "amp", "lr", "epochs")}},
        "baseline_zero_filled": base,
        "varnet_final": final,
        "varnet_best": {"epoch": min(hist, key=lambda h: h[
            "validation_loss"])["epoch"], **best},
        "nmse_by_epoch": [h["nmse"] for h in hist],
        "train_loss_first": hist[0]["train_loss"],
        "train_loss_last": hist[-1]["train_loss"],
        "seconds_by_epoch": [h["seconds"] for h in hist],
        "data_s": data_s, "wall_s": wall,
        "bounds": bounds, "bounds_held": all(bounds.values()),
    }
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(hist, f, indent=1)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def evaluate(recipe: str, ckpt: str, device: str = "cuda") -> dict:
    """Score a VarNet checkpoint in the port's format (``varnet_best.ckpt``
    and its ``.args.json``, e.g. a JAX run's weights carried over by
    ``models/convert.py:state_dict_from_flax_varnet``) on the recipe's
    validation slices: :func:`eval_model` and the zero-filled baseline."""
    val_ds, val_zf = make_samples(recipe, "val")
    with open(ckpt + ".args.json", encoding="utf-8") as f:
        saved = json.load(f)
    args = VarNetArgs(**{**saved, "out_dir": os.path.dirname(
        os.path.abspath(ckpt))})
    trainer = VarNetTrainer(args, None, val_ds, device=device)
    trainer._init_if_needed(val_ds[0].kspace, val_ds[0].espirit)
    trainer.model.load_state_dict(ckpt_lib.load_best(ckpt))
    return {"recipe": recipe, "ckpt": ckpt, "amp": args.amp,
            "baseline_zero_filled": eval_baseline(val_ds, val_zf, args.crop),
            "varnet": eval_model(trainer)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("VarNet on synthetic multi-coil phantoms")
    p.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="cut the recipe's depth (no quality gate then)")
    p.add_argument("--seed", type=int, default=None,
                   help="the weights' seed (default VarNetArgs' 42)")
    p.add_argument("--eval-ckpt", default=None,
                   help="score this checkpoint on the recipe's validation "
                        "slices instead of training")
    p.add_argument("--no-amp", action="store_true",
                   help="compute in f32 (TF32 off), not the recipe's dtype")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    a = p.parse_args(argv)
    if a.eval_ckpt:
        print(json.dumps(evaluate(a.recipe, a.eval_ckpt, a.device)),
              flush=True)
        return 0
    summary = run(a.recipe, a.device, a.out_dir, a.epochs, a.seed,
                  False if a.no_amp else None)
    print(json.dumps(summary), flush=True)
    return 0 if (a.epochs is not None or summary["bounds_held"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
