"""Reconstruction metrics: MSE, NMSE, PSNR, SSIM and a running aggregator.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/metrics/recon_eval.py``,
the prostate code's ``evaluate.py:21-169``: ``mse``, ``nmse`` and ``psnr``
(skimage's ``peak_signal_noise_ratio``) on numpy arrays, copied as they
are; ``ssim``, the mean over slices of skimage's ``structural_similarity``
at its defaults (a uniform 7x7 window, ``K1 = 0.01``, ``K2 = 0.03``, the
sample covariance, the mean over the valid interior), whose window sums run
in torch (``train/ssim.py:ssim_map``) on ``device``, or where the input
lies when it is None (a numpy array lies on the CPU); and ``Metrics``,
running means and standard deviations (Welford), as ``runstats`` keeps
them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..train.ssim import ssim_map


def mse(gt: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean((gt - pred) ** 2))


def nmse(gt: np.ndarray, pred: np.ndarray) -> float:
    return float(np.linalg.norm(gt - pred) ** 2 / np.linalg.norm(gt) ** 2)


def psnr(gt: np.ndarray, pred: np.ndarray,
         maxval: Optional[float] = None) -> float:
    if maxval is None:
        maxval = float(gt.max())
    err = np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2)
    if err == 0.0:
        # identical images: PSNR is +inf by definition
        return float("inf")
    return float(10.0 * np.log10((maxval ** 2) / err))


def _as_tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device) if device is not None else t


def _ssim_2d(x, y, data_range: float, win_size: int = 7, k1: float = 0.01,
             k2: float = 0.03, device=None) -> torch.Tensor:
    """skimage ``structural_similarity`` (defaults) of one 2-D pair, a 0-d
    f32 tensor on ``device`` (None: where ``x`` lies)."""
    x, y = _as_tensor(x, device), _as_tensor(y, device)
    s = ssim_map(x[None, None], y[None, None].to(x.device), float(data_range),
                 win_size, k1, k2)
    return s.mean()


def ssim(gt: np.ndarray, pred: np.ndarray, maxval: Optional[float] = None,
         device=None) -> float:
    """Volume SSIM: the mean of per-slice SSIM (``evaluate.py:40-57``)."""
    if gt.ndim != 3:
        raise ValueError("Unexpected number of dimensions in ground truth.")
    if gt.ndim != pred.ndim:
        raise ValueError("Ground truth dimensions does not match pred.")
    maxval = float(gt.max()) if maxval is None else float(maxval)
    g, p = _as_tensor(gt, device), _as_tensor(pred, device)
    per_slice = [_ssim_2d(g[s], p[s], maxval) for s in range(gt.shape[0])]
    total = 0.0
    for v in torch.stack(per_slice).cpu().tolist():
        total += v
    return total / gt.shape[0]


METRIC_FUNCS = dict(MSE=mse, NMSE=nmse, PSNR=psnr, SSIM=ssim)


class _RunningStat:
    """Welford online mean / stddev (``runstats.Statistics``)."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def push(self, v: float):
        self.n += 1
        d = v - self._mean
        self._mean += d / self.n
        self._m2 += d * (v - self._mean)

    def mean(self) -> float:
        return self._mean

    def stddev(self) -> float:
        return float(np.sqrt(self._m2 / (self.n - 1))) if self.n > 1 else 0.0


class Metrics:
    """Running statistics over a collection of metric functions."""

    def __init__(self, metric_funcs: Dict = None):
        metric_funcs = metric_funcs or METRIC_FUNCS
        self.metric_funcs = metric_funcs
        self.metrics = {m: _RunningStat() for m in metric_funcs}

    def push(self, target: np.ndarray, recons: np.ndarray) -> None:
        for metric, func in self.metric_funcs.items():
            self.metrics[metric].push(func(target, recons))

    def means(self) -> Dict[str, float]:
        return {m: s.mean() for m, s in self.metrics.items()}

    def stddevs(self) -> Dict[str, float]:
        return {m: s.stddev() for m, s in self.metrics.items()}

    def __repr__(self) -> str:
        means, stddevs = self.means(), self.stddevs()
        return " ".join(
            f"{name} = {means[name]:.4g} +/- {2 * stddevs[name]:.4g}"
            for name in sorted(means))
