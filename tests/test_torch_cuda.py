"""The port's CUDA kernels against their plain versions, and the training,
evaluation, bf16 and int8 inference paths, the classical recon and the
pickle ingest route against the CPU, on the card.

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
    (hundreds of plain sweeps), a comb, one-pixel rings and components on
    every border: the kernels' int32 labels equal the plain version's, in
    one wrapper call."""
    m = dict(synthetic.component_masks(np.random.default_rng(0)))[name]
    x = torch.from_numpy(m.astype(np.uint8)).to(card)
    before = components.LAUNCHES["label_components"]
    got = components.label_components(x)
    torch.cuda.synchronize()
    assert components.LAUNCHES["label_components"] == before + 1
    assert got.dtype == torch.int32
    want, sweeps = components.label_components_reference(x,
                                                         return_sweeps=True)
    assert torch.equal(got, want)
    assert bool((sweeps >= 1).all())
    if name == "maze":
        assert int(sweeps[0]) >= 300


def _check_labels(m: np.ndarray):
    x = torch.from_numpy(m.astype(np.uint8)).to("cuda")
    before = components.LAUNCHES["label_components"]
    got = components.label_components(x)
    torch.cuda.synchronize()
    assert components.LAUNCHES["label_components"] == before + 1
    assert torch.equal(got, components.label_components_reference(x)), (
        m.shape)


@pytest.mark.parametrize("density", [0.3, 0.6, 0.9])
def test_label_components_kernel_on_random_volumes(card, density):
    """Random (35, 640, 368) stacks: many components and unions across
    every tile edge."""
    _check_labels(np.random.default_rng(int(density * 10)).random(
        (35, 640, 368)) < density)


@pytest.mark.parametrize("h", [63, 64, 65])
def test_label_components_kernel_across_tile_edges(card, h):
    """Heights and widths of 63, 64 and 65: the second tile row and column
    empty, full and one pixel wide."""
    rng = np.random.default_rng(h)
    for w in (63, 64, 65):
        _check_labels(np.stack([rng.random((h, w)) < d
                                for d in (0.3, 0.6, 0.9)]))


def test_label_components_kernel_on_the_probe_mask(card):
    """The probe's random 320x320 mask (density 0.6)."""
    _check_labels((np.random.default_rng(0).random((320, 320)) > 0.4)[None])


def test_label_components_kernel_is_the_same_every_call(card):
    """Twenty calls on one random stack: the atomics' order differs from
    call to call, the labels must not."""
    m = torch.from_numpy((np.random.default_rng(2).random((8, 640, 368))
                          < 0.6).astype(np.uint8)).to(card)
    first = components.label_components(m)
    assert torch.equal(first, components.label_components_reference(m))
    for _ in range(19):
        assert torch.equal(components.label_components(m), first)


def test_label_components_kernel_reads_nothing_back(card):
    m = torch.from_numpy((np.random.default_rng(3).random((8, 640, 368))
                          < 0.6).astype(np.uint8)).to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = components.label_components(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, components.label_components_reference(m))


def test_label_components_launches_its_three_kernels(card):
    """One wrapper call launches the three kernels of the design."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.utils.cuda_timing import (
        kernel_trace)
    m = torch.from_numpy((np.random.default_rng(4).random((8, 640, 368))
                          < 0.6).astype(np.uint8)).to(card)
    trace = kernel_trace(lambda: components.label_components(m), runs=3)
    assert set(trace["kernel_us"]) == {"cc_local_kernel", "cc_merge_kernel",
                                       "cc_compress_kernel"}
    assert trace["kernels_per_call"] == 3


def test_label_components_kernel_on_a_volume_and_in_the_body_mask(card):
    """A random (35, 640, 368) stack, and the body mask's small-object
    removal, which runs the kernels once for the stack."""
    m = torch.from_numpy((np.random.default_rng(1).random((35, 640, 368))
                          < 0.6).astype(np.uint8)).to(card)
    assert torch.equal(components.label_components(m),
                       components.label_components_reference(m))
    before = components.LAUNCHES["label_components"]
    got = maskops.remove_small_objects(m, 256)
    assert components.LAUNCHES["label_components"] == before + 1
    assert torch.equal(got.cpu(), maskops.remove_small_objects(m.cpu(), 256))


@pytest.mark.parametrize("shape,iters", [
    ((320, 320), 128), ((1, 1), 3), ((7, 5), 9), ((33, 47), 40),
    ((64, 368), 0), ((320, 368), 200), ((8, 320), 13),
    ((320, 320), 3 * components.PROP_HALO + 5), ((640, 368), 37),
    ((200, 100), 21)])
def test_masked_max_prop_kernel_bit_equal_to_plain(card, shape, iters):
    """The probe's shape and step count, odd shapes, (320, 368) at 200
    steps, an (8, 320) image (a band of one row a block), step counts that
    are not a multiple of the halo, the largest image of the tests (40-row
    bands) and one whose last block owns fewer rows than the halo."""
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


def test_masked_max_prop_refuses_an_image_one_cluster_cannot_hold(card):
    m = torch.zeros(640, 640, device=card)
    with pytest.raises(ValueError):
        components.masked_max_prop(m, m, 1)


# ---------------------------------------------------------------------------
# bf16 and int8 inference (infer/quant.py, cli/infer.py:model_apply_fn)
# ---------------------------------------------------------------------------

def _blob_batch(rng, n, hw=64):
    """Noisy disc images and masks, NCHW (tests/test_quant.py's data)."""
    yy, xx = np.mgrid[:hw, :hw]
    xs, ys = [], []
    for _ in range(n):
        cy, cx = rng.integers(16, hw - 16), rng.integers(16, hw - 16)
        r = rng.integers(8, 16)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        xs.append((m + 0.15 * rng.standard_normal((hw, hw)))[None])
        ys.append(m[None])
    return (torch.from_numpy(np.stack(xs).astype(np.float32)),
            torch.from_numpy(np.stack(ys).astype(np.float32)))


def _trained_unet():
    """The CPU tests' model: a ResNet18 U-Net with the default decoder
    after 24 Adam steps on blob images, trained on the CPU."""
    import torch.nn.functional as F
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
        build_unet)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
        init_weights)
    torch.manual_seed(4)
    model = init_weights(build_unet("unet", "resnet18"),
                         torch.Generator().manual_seed(4))
    opt = torch.optim.Adam(model.parameters(), 3e-3)
    rng = np.random.default_rng(4)
    for _ in range(24):
        x, y = _blob_batch(rng, 4)
        loss = F.binary_cross_entropy_with_logits(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return model.eval()


def test_int8_conv_exact_on_the_card(card):
    """K = 3*3*768 with sums past 2^24 (tests/test_torch_quant.py's data):
    the card's int32 sums equal int64 numpy's."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.infer.quant import (
        int8_conv)
    rng = np.random.default_rng(0)
    x = rng.integers(90, 128, (2, 6, 5, 768))
    x[0, :, :, ::7] = rng.integers(-127, 128, x[0, :, :, ::7].shape)
    x[1] = -x[1]
    w = rng.integers(90, 128, (3, 3, 768, 16))
    w[..., ::5] = rng.integers(-127, 128, w[..., ::5].shape)
    got = int8_conv(torch.from_numpy(x.astype(np.int8)).to(card),
                    torch.from_numpy(w.astype(np.int8)).to(card), 1, 1)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((2, 6, 5, 16), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("nhwc,co->nhwo", xp[:, dy:dy + 6, dx:dx + 5],
                              w[dy, dx])
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_int8_logits_on_the_card_match_the_cpu(card, cdt):
    """One artifact on both devices: the integer convolutions are exact and
    everything else is correctly rounded elementwise work, so the logits
    are bit-equal."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.infer.quant import (
        DTYPES, QuantConfig, QuantizedUNet2D)
    model = _trained_unet()
    rng = np.random.default_rng(2)
    eng, tree = QuantizedUNet2D.from_model(
        model, [_blob_batch(rng, 4)[0] for _ in range(2)],
        QuantConfig("int8", DTYPES[cdt]))
    x = _blob_batch(rng, 6)[0]
    want = eng.apply(tree, x)
    on_card = {p: {k: None if t is None else t.to(card)
                   for k, t in leaf.items()} for p, leaf in tree.items()}
    got = eng.apply(on_card, x.to(card)).cpu()
    assert torch.equal(got, want), float((got - want).abs().max())


def test_bf16_logits_on_the_card_match_the_cpu(card):
    """An ``amp`` model through ``model_apply_fn`` on both devices: within
    tests/test_torch_infer.py's bound, 8 bf16 spacings at the largest
    |logit|, and equal masks wherever |logit| exceeds it."""
    import copy
    from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
        model_apply_fn)
    model = _trained_unet()
    model.compute_dtype = torch.bfloat16
    x = _blob_batch(np.random.default_rng(5), 4)[0]
    with torch.inference_mode():
        want = model_apply_fn(model, lambda t: t)(x)
        got = model_apply_fn(copy.deepcopy(model).to(card),
                             lambda t: t)(x.to(card)).cpu()
    bound = 8 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= bound
    far = want.abs() > bound
    assert torch.equal((got > 0)[far], (want > 0)[far])


# ---------------------------------------------------------------------------
# Classical recon and the pickle ingest route
# ---------------------------------------------------------------------------

RECON_REL = 1e-4     # card vs CPU recon, relative to the CPU map's max
EPI = {"rampUpTime": 100.0, "rampDownTime": 100.0, "flatTopTime": 400.0,
       "acqDelayTime": 10.0, "echoSpacing": 1.0}


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_t2_reconstruction_on_the_card_matches_the_cpu(card):
    """Two slices of 8 coils at 96 x 64, R = 3 with an ACS band: the card
    (TF32 off inside the recon, torch's flags left as found) within 1e-4
    of the image maximum of the CPU."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.recon import (
        t2_reconstruction)
    rng = np.random.default_rng(0)
    k = _cplx(rng, (3, 2, 8, 96, 64))
    keep = np.zeros(64, bool)
    keep[::3] = True
    keep[26:38] = True
    k[..., ~keep] = 0
    calib = _cplx(rng, (2, 8, 96, 16))
    before = _flags()
    got = t2_reconstruction(k, calib, hdr=4.0, device=card)
    assert _flags() == before
    want = t2_reconstruction(k, calib, hdr=4.0, device="cpu")
    g, w = got["reconstruction_rss"], want["reconstruction_rss"]
    assert g.shape == w.shape == (2, 96, 72)
    assert np.abs(g - w).max() <= RECON_REL * np.abs(w).max()


def test_dwi_reconstruction_on_the_card_matches_the_cpu(card):
    """51 averages, 2 slices of 2 coils at 200 x 24, R = 2: every map
    within 1e-4 of its maximum of the CPU's, except at most 0.1 % of the
    pixels of the thresholded ADC and b1500 maps."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.recon import (
        dwi_reconstruction)
    rng = np.random.default_rng(1)
    k = _cplx(rng, (51, 2, 2, 200, 24), 0.1)
    keep = np.zeros(24, bool)
    keep[::2] = True
    keep[8:16] = True
    k[..., ~keep] = 0
    calib, sens = _cplx(rng, (2, 2, 200, 24), 0.1), _cplx(rng, (2, 2, 200,
                                                               24))
    got = dwi_reconstruction(k, calib, sens, EPI, device=card)
    want = dwi_reconstruction(k, calib, sens, EPI, device="cpu")
    assert set(got) == set(want)
    for key in want:
        past = (np.abs(got[key] - want[key])
                > RECON_REL * np.abs(want[key]).max()).sum()
        limit = 1e-3 * want[key].size if key in ("adc_map", "b1500") else 0
        assert past <= limit, (key, past)


def test_grappa_fill_on_the_card_with_the_cpu_weights(card):
    """The CPU's weights carried to the card: the filled k-space agrees to
    f32 rounding (1e-5 of its largest magnitude), the solve kept out."""
    from mri_acl_imagesegmentation_adsp_tpu_torch.recon.grappa import Grappa
    rng = np.random.default_rng(2)
    k = _cplx(rng, (2, 3, 48, 6, 40))               # (S, B, X, C, Y)
    k[:, :, 1::2] = 0
    calibs = _cplx(rng, (2, 16, 6, 40))
    cpu = Grappa(k[0, 0], coil_axis=1, device="cpu")
    on_card = Grappa(k[0, 0], coil_axis=1, device=card)
    weights = cpu.compute_weights_batch(calibs)
    want = cpu.apply_weights_pair_multi(torch.from_numpy(k), weights)
    got = on_card.apply_weights_pair_multi(torch.from_numpy(k).to(card),
                                           weights).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    grams = on_card.compute_grams(calibs)
    want_g = cpu.compute_grams(calibs)
    assert np.abs(grams - want_g).max() <= 1e-5 * np.abs(want_g).max()


def test_pickle_ingest_on_the_card_launches_each_mask_kernel_once_a_volume(
        card, tmp_path):
    """build_preprocess with KneePckAdapter on the card: one open_close and
    one label_components launch a volume, and the packs as the CPU's
    (masks in at most 0.1 % of pixels, tensor within 1e-4 on the slices
    whose masks agree)."""
    import pickle
    from types import SimpleNamespace
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.adapters import (
        KneePckAdapter)
    from mri_acl_imagesegmentation_adsp_tpu_torch.data.packer import (
        build_preprocess)
    root = tmp_path / "pck"
    root.mkdir()
    for i in range(2):
        with open(root / f"vol{i}.pck", "wb") as f:
            pickle.dump({"data": synthetic.synthetic_knee_volume(
                i, 20, 160, 128)}, f)
    spec = dict(root_dir=str(root), height=64, width=64,
                slice_keep="0.3,0.7", clip="1.0,99.5", use_n4=False,
                use_denoise=False, preview_max=0)
    before = (morphology.LAUNCHES, components.LAUNCHES["label_components"])
    out = build_preprocess(SimpleNamespace(
        out_dir=str(tmp_path / "card"), device=str(card), **spec),
        KneePckAdapter())
    assert (morphology.LAUNCHES - before[0],
            components.LAUNCHES["label_components"] - before[1]) == (2, 2)
    build_preprocess(SimpleNamespace(out_dir=str(tmp_path / "cpu"),
                                     device="cpu", **spec), KneePckAdapter())
    for e in out:
        name = pathlib.Path(e["output_dir"]).name
        with np.load(e["npz_path"]) as a, \
                np.load(tmp_path / "cpu" / name / "volume.npz") as b:
            assert (a["msk"] != b["msk"]).mean() <= 1e-3
            same = (a["msk"] == b["msk"]).reshape(len(a["msk"]), -1).all(1)
            assert same.any()
            assert np.abs(a["img"][same] - b["img"][same]).max() <= 1e-4
