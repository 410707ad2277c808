"""Report-time metrics: segmentation (``medimetrics``) and reconstruction
(``recon_eval``), exported as the JAX package's ``metrics/__init__.py``
exports them."""

from .medimetrics import assd, dice_bin, hd95, iou_bin
from .recon_eval import METRIC_FUNCS, Metrics, mse, nmse, psnr, ssim

__all__ = ["dice_bin", "iou_bin", "hd95", "assd",
           "mse", "nmse", "psnr", "ssim", "METRIC_FUNCS", "Metrics"]
