"""The port's CUDA kernel against its plain version, on the card.

Run on a machine with an NVIDIA card and nvcc (``--noconftest``: that
machine has no JAX, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Elsewhere every test here skips (the kernel has no CPU mode).
"""
import pathlib

import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu_torch.ops import maskops
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import morphology

pytestmark = pytest.mark.cuda
GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 96, 80), (8, 320, 320),
                                   (35, 640, 368), (2, 1, 1), (1, 33, 47)])
def test_open_close_kernel_bit_equal_to_plain(card, shape):
    m = torch.from_numpy((np.random.default_rng(0).random(shape) > 0.55)
                         .astype(np.uint8)).to(card)
    before = morphology.LAUNCHES
    got = morphology.open_close(m)
    torch.cuda.synchronize()
    assert morphology.LAUNCHES == before + 1
    assert torch.equal(got, morphology.open_close_reference(m))
    assert torch.equal(got.cpu(), morphology.open_close(m.cpu()))


@pytest.mark.parametrize("case", ["ones", "zeros", "single_pixel"])
def test_open_close_kernel_border_cases(card, case):
    m = torch.zeros(1, 32, 32, dtype=torch.uint8, device=card)
    if case == "ones":
        m.fill_(1)
    elif case == "single_pixel":
        m[0, 16, 16] = 1
    got = morphology.open_close(m)
    assert bool(got.all()) if case == "ones" else not bool(got.any())


def test_body_mask_on_the_card_matches_the_goldens(card):
    z = np.load(GOLDENS / "preprocess_goldens.npz")
    imgs = torch.from_numpy(np.stack([z[f"img_{i}"] for i in range(8)]))
    got = maskops.body_mask(imgs.to(card)).cpu().numpy()
    for i in range(8):
        np.testing.assert_array_equal(got[i], z[f"mask_{i}"])
