"""The yardstick's frozen numbers: FLOPs a slice of the plain models,
their parameter counts and the mask kernels' bytes and least times."""

import math

import pytest

from benchmark.counts import mask_kernels as mk
from benchmark.counts.flops import flops_per_slice
from benchmark.counts.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from benchmark.harness import ROOT, load_json
from benchmark.reference.models import param_shapes


@pytest.mark.parametrize("model,forward,train", [("unet", 24.10, 72.13)])
def test_flops_per_slice(model, forward, train):
    assert round(flops_per_slice(model, 320, 320, False) / 1e9, 2) == forward
    assert round(flops_per_slice(model, 320, 320, True) / 1e9, 2) == train


@pytest.mark.parametrize("config", ["unet_r34_320"])
def test_parameters_match_config(config):
    cfg = load_json(ROOT / "benchmark" / "configs" / f"{config}.json")
    n = sum(math.prod(s) for _, s in param_shapes(cfg["model"]))
    assert n == cfg["parameters"]


def test_mask_kernel_counts_at_a_knee_volume():
    shape = (35, 640, 368)
    assert mk.open_close_bytes(shape) == 2 * 35 * 640 * 368
    assert mk.label_components_bytes(shape) == 5 * 35 * 640 * 368
    assert mk.open_close_ops(shape) == 80 * 35 * 640 * 12
    # the bounds of the port's kernel table: 4.92 us and 12.3 us, by bytes
    assert mk.open_close_bound_s(shape) == pytest.approx(4.92e-6, rel=2e-3)
    assert mk.label_components_bound_s(shape) == pytest.approx(12.3e-6,
                                                               rel=2e-3)
    assert mk.mask_kernels_bound_s(shape) == pytest.approx(
        7 * 35 * 640 * 368 / HBM_BYTES_PER_S)


def test_peaks():
    assert BF16_FLOP_PER_S == 989e12 and HBM_BYTES_PER_S == 3.35e12
