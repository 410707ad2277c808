"""The port's CUDA kernel against its plain version, and the training path
against the CPU, on the card.

Run on a machine with an NVIDIA card and nvcc (``--noconftest``: that
machine has no JAX, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Elsewhere every test here skips (the kernel has no CPU mode).
"""
import pathlib

import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu_torch.data.hbm_loader import (
    SliceStore)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
    pack_kspace_volume)
from mri_acl_imagesegmentation_adsp_tpu_torch.data.preprocess import (
    MRIKneePreprocessor)
from mri_acl_imagesegmentation_adsp_tpu_torch.ops import maskops
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import morphology
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    synthetic_kspace_pairs)

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


# The word and band edges of the kernel; chip_smoke.py phase 2 checks the
# same list. Each case is a stack of one slice per density.
EDGE_W = (1, 31, 32, 33, 63, 64, 65, 368, 369)
DENSITIES = (0.05, 0.5, 0.95)
EDGE_HEIGHTS = [(1, None), (2, None), (640, None)] + [
    (r + d, r) for r in morphology.BAND_ROWS for d in (-1, 0, 1, 9)]


def _check(m: np.ndarray, band_rows=None):
    x = torch.from_numpy(m.astype(np.uint8)).to("cuda")
    before = morphology.LAUNCHES
    got = morphology._open_close(x, band_rows)
    torch.cuda.synchronize()
    assert morphology.LAUNCHES == before + 1
    assert torch.equal(got, morphology.open_close_reference(x)), (
        m.shape, band_rows)


@pytest.mark.parametrize("w", EDGE_W)
def test_open_close_kernel_word_and_band_edges(card, w):
    """W across the 32-bit word edges and the 16-byte rows of the aligned
    path; H at 1, 2, 640 with the wrapper's band height and at R-1, R, R+1,
    R+9 for each band height R it can pick."""
    rng = np.random.default_rng(w)
    for h, band_rows in EDGE_HEIGHTS:
        _check(np.stack([rng.random((h, w)) < d for d in DENSITIES]),
               band_rows)


@pytest.mark.parametrize("s", [1, 8, 35])
def test_open_close_kernel_stack_sizes(card, s):
    rng = np.random.default_rng(s)
    _check(np.stack([rng.random((640, 368)) < DENSITIES[i % 3]
                     for i in range(s)]))


def test_open_close_kernel_any_alignment(card):
    """Tensors that start off a 16-byte boundary take the bit-stream path
    and must give the same bits."""
    rng = np.random.default_rng(7)
    m = torch.from_numpy((rng.random((3, 70, 368)) < 0.5).astype(np.uint8))
    flat = torch.zeros(m.numel() + 16, dtype=torch.uint8, device="cuda")
    for offset in (1, 3, 8):
        x = flat[offset:offset + m.numel()].view(m.shape)
        x.copy_(m.to("cuda"))
        got = morphology._open_close(x, 16)
        assert torch.equal(got, morphology.open_close_reference(x))


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


def test_pack_kspace_volume_on_the_card_launches_the_kernel_once(card,
                                                                  tmp_path):
    """The training path's kernel: one open/close launch per packed volume,
    and the card's pack as the CPU's (masks in at most 0.1 % of pixels,
    tensor within 1e-4 on the slices whose masks agree)."""
    pair = synthetic_kspace_pairs(seed=0, s=35, h=640, w=368)
    kw = dict(out_size=(320, 320), slice_keep=(0.3, 0.7))
    before = morphology.LAUNCHES
    info = pack_kspace_volume(MRIKneePreprocessor(device=card, **kw), pair,
                              str(tmp_path / "card"))
    assert morphology.LAUNCHES == before + 1 and info["num_slices"] == 14
    pack_kspace_volume(MRIKneePreprocessor(device="cpu", **kw), pair,
                       str(tmp_path / "cpu"))
    with np.load(tmp_path / "card" / "volume.npz") as a, \
            np.load(tmp_path / "cpu" / "volume.npz") as b:
        assert (a["msk"] != b["msk"]).mean() <= 1e-3
        same = (a["msk"] == b["msk"]).reshape(14, -1).all(axis=1)
        assert same.any()
        assert np.abs(a["img"][same] - b["img"][same]).max() <= 1e-4


def test_train_step_on_the_card_matches_the_cpu(card, tmp_path):
    """One engine step at full width, card vs CPU, at ``chip_smoke.py``
    phase 6's tolerances (it raises past them)."""
    import chip_smoke
    pre = MRIKneePreprocessor(out_size=(320, 320), device=card)
    pack_kspace_volume(pre, synthetic_kspace_pairs(seed=1, s=35, h=640,
                                                   w=368),
                       str(tmp_path / "vol"))
    src = SliceStore.from_files([str(tmp_path / "vol" / "volume.npz")])
    flags = chip_smoke._precision_flags()
    chip_smoke._set_precision_flags({"cudnn_allow_tf32": False,
                                     "matmul_allow_tf32": False,
                                     "cudnn_deterministic": True})
    try:
        out = chip_smoke.step_parity(card, src)
    finally:
        chip_smoke._set_precision_flags(flags)
    assert out["loss_rel_err"] <= chip_smoke.STEP_LOSS_RTOL
