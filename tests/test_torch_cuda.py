"""The port's CUDA kernels against their plain versions, and the training
and evaluation paths against the CPU, on the card.

Run on a machine with an NVIDIA card and nvcc (``--noconftest``: that
machine has no JAX, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Elsewhere every test here skips (the kernels have no CPU mode).
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
from mri_acl_imagesegmentation_adsp_tpu_torch.ops.kernels import (
    components, morphology)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils import synthetic
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


def test_evaluate_volume_on_the_card_matches_the_cpu(card):
    """evaluate_volume at 8 x 320 x 320 with chip_smoke.py phase 7's
    tolerances: the exact EDT bit-equal, per-slice Dice / IoU / HD95 / ASSD
    within 1e-6 relative, the volume means within 1e-6."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.infer.segment import (
        evaluate_volume, slice_metrics)
    from mri_acl_imagesegmentation_adsp_tpu_torch.ops import edt
    yy, xx = np.mgrid[:320, :320]
    gt = np.stack([(yy - 160 - 4 * i) ** 2 + (xx - 150) ** 2 < 90 ** 2
                   for i in range(8)]).astype(np.uint8)
    pred = np.zeros_like(gt)
    pred[..., 3:] = gt[..., :-3]
    pred[:, 100:140, 100:160] = 0       # a hole: HD95 above 0
    pt, gtt = torch.from_numpy(pred), torch.from_numpy(gt)
    assert torch.equal(edt.edt(gtt.to(card) == 0).cpu(), edt.edt(gtt == 0))
    got = slice_metrics(pt.to(card), gtt.to(card)).cpu().numpy()
    want = slice_metrics(pt, gtt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want[:, 2:] > 0).all()
    card_means = evaluate_volume(pt.to(card), gtt.to(card))
    assert card_means == pytest.approx(evaluate_volume(pt, gtt), rel=1e-6)


def test_unetpp_logits_on_the_card_match_the_cpu(card):
    """UNet++ (resnet34, the reference decoder) at 2 x 1 x 128 x 128 with
    TF32 off: logits within 1e-3 of max |logit| (chip_smoke.LOGIT_RTOL)."""
    import copy
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
        init_weights)
    model = init_weights(build_unet("unetpp", "resnet34"),
                         torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 1, 128, 128, generator=torch.Generator().manual_seed(1))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = model(x)
            got = copy.deepcopy(model).to(card)(x.to(card)).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


# ---------------------------------------------------------------------------
# csrc/label_prop.cu: connected components and the probe's propagation
# ---------------------------------------------------------------------------

CC_CASES = [name for name, _ in synthetic.component_masks(
    np.random.default_rng(0))]


@pytest.mark.parametrize("name", CC_CASES)
def test_label_components_kernel_bit_equal_to_plain(card, name):
    """Every width across the 32-pixel tiles at H = 1 and 37, all
    foreground and background, a checkerboard, the 640x368 serpentine
    (hundreds of sweeps), one-pixel rings and components on every border:
    the kernel's int32 labels equal the plain version's, in one launch."""
    m = dict(synthetic.component_masks(np.random.default_rng(0)))[name]
    x = torch.from_numpy(m.astype(np.uint8)).to(card)
    sweeps = torch.zeros(m.shape[0], dtype=torch.int32, device=card)
    before = components.LAUNCHES["label_components"]
    got = components.label_components(x, sweeps)
    torch.cuda.synchronize()
    assert components.LAUNCHES["label_components"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, components.label_components_reference(x))
    assert bool((sweeps >= 1).all())
    if name == "maze":
        assert int(sweeps[0]) >= 300


def test_label_components_kernel_on_a_volume_and_in_the_body_mask(card):
    """A random (35, 640, 368) stack, and the body mask's small-object
    removal, which runs the kernel once for the stack."""
    m = torch.from_numpy((np.random.default_rng(1).random((35, 640, 368))
                          < 0.6).astype(np.uint8)).to(card)
    assert torch.equal(components.label_components(m),
                       components.label_components_reference(m))
    before = components.LAUNCHES["label_components"]
    got = maskops.remove_small_objects(m, 256)
    assert components.LAUNCHES["label_components"] == before + 1
    assert torch.equal(got.cpu(), maskops.remove_small_objects(m.cpu(), 256))


@pytest.mark.parametrize("shape,iters", [((320, 320), 128), ((1, 1), 3),
                                         ((7, 5), 9), ((33, 47), 40),
                                         ((64, 368), 0)])
def test_masked_max_prop_kernel_bit_equal_to_plain(card, shape, iters):
    rng = np.random.default_rng(0)
    mask = (rng.random(shape) > 0.4).astype(np.float32)
    x = (np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
         ) * mask
    mt, xt = torch.from_numpy(mask).to(card), torch.from_numpy(x).to(card)
    before = components.LAUNCHES["masked_max_prop"]
    got = components.masked_max_prop(mt, xt, iters)
    torch.cuda.synchronize()
    assert components.LAUNCHES["masked_max_prop"] == before + 1
    assert torch.equal(got, components.masked_max_prop_reference(mt, xt,
                                                                 iters))
