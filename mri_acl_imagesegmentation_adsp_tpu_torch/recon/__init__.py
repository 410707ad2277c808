"""Classical reconstruction: Cartesian single- and multi-coil, GRAPPA, and
the prostate T2 and DWI pipelines.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/`` without
``varnet.py``, which is not ported yet.
"""

from .cartesian import (center_crop_im, flip_im, ifftnd_scaled,
                        recon_multicoil_rss, recon_singlecoil)
from .dwi import (adc, b1500, compute_averages, compute_trace_adc_b1500,
                  dwi_reconstruction, trace, trapezoidal_regridding)
from .grappa import Grappa
from .t2 import create_coil_combined_im, t2_reconstruction

__all__ = [
    "recon_singlecoil", "recon_multicoil_rss", "ifftnd_scaled",
    "center_crop_im", "flip_im", "Grappa",
    "t2_reconstruction", "create_coil_combined_im",
    "dwi_reconstruction", "trapezoidal_regridding", "compute_averages",
    "trace", "adc", "b1500", "compute_trace_adc_b1500",
]
