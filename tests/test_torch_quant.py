"""Parity of the PyTorch port's int8 quantization (``infer/quant.py``,
``cli/quantize.py``) with the JAX package's.

The models are ResNet18 U-Nets and UNet++ with the narrow decoder of
``tests/test_quant.py``, trained briefly in the port on blob images and
carried into Flax trees, so both packages hold the same weights.
Tolerances, each stated where it is checked:

- the int8 convolution: bit-equal to an int64 numpy reference at
  K = 3*3*768 with sums past 2^24 (an f32-accumulating conv is not);
- every conv's int32 accumulator, on a JAX-written artifact, bit-equal to
  JAX's for the same int8 input;
- int8 logits on a JAX-written artifact: bit-equal to JAX's ``apply`` (run
  op by op, as written), in f32 and bf16 (the tolerance is 0, tighter than
  1e-3 of max |logit|);
- ``folded`` logits within 1e-4 (U-Net) and 2e-4 (UNet++), absolute and
  relative, of JAX's ``apply_folded``, as ``tests/test_quant.py`` pins it;
- ``from_model`` from the same weights and calibration batches:
  ``x_scale`` within 1e-6 relative, ``w_scale`` and the folded biases
  within 1e-6, ``w_q`` equal but for at most 8 weights off by one (the
  fold's rsqrt rounds differently in the two libraries), the count
  printed;
- int8 against f32 predictions on a trained model: Dice >= 0.98 and logit
  correlation > 0.99 where |logit| > 1, as ``tests/test_quant.py`` pins it.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_quant import _blob_batch

from mri_acl_imagesegmentation_adsp_tpu.cli import quantize as jax_quantize
from mri_acl_imagesegmentation_adsp_tpu.infer import quant as jq
from mri_acl_imagesegmentation_adsp_tpu.models.unet2d import (
    ResNetEncoderUNet as JaxUNet, UNetPlusPlus as JaxUNetPP)
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jax_ckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import quantize
from mri_acl_imagesegmentation_adsp_tpu_torch.infer import quant
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    _module_path, state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint

TINY = (32, 16, 8, 8, 8)
HW = 64
JAX_CLS = {"unet": JaxUNet, "unetpp": JaxUNetPP}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _trained_state(arch: str, steps: int, seed: int, decoder: tuple):
    torch.manual_seed(seed)
    model = init_weights(build_unet(arch, "resnet18", classes=1,
                                    decoder_channels=decoder),
                         torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), 3e-3)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x, y = _blob_batch(rng, 4, HW)
        loss = F.binary_cross_entropy_with_logits(
            model(nchw(x)), torch.from_numpy(y)[:, None])
        opt.zero_grad()
        loss.backward()
        opt.step()
    loss = float(loss.detach())
    assert loss < 0.35, f"toy training failed to descend: {loss}"
    return model.state_dict()


def train_port_model(arch: str, steps: int = 24, seed: int = 0,
                     decoder=TINY):
    """A few Adam steps of the port's model on blob images, BN in train
    mode: enough for confident logits and running stats that are not the
    identity. Trained once a process for each setting."""
    model = build_unet(arch, "resnet18", classes=1,
                       decoder_channels=tuple(decoder))
    model.load_state_dict(_trained_state(arch, steps, seed, tuple(decoder)))
    return model.eval()


def flax_variables(jax_model, state_dict) -> dict:
    """The port's state_dict as the Flax tree of ``jax_model``: the inverse
    of ``state_dict_from_flax``."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 1)), train=True))
    unetpp = isinstance(jax_model, JaxUNetPP)

    def fill(path, s):
        keys = tuple(p.key for p in path)
        coll, mod, leaf = keys[0], keys[1:-1], keys[-1]
        prefix = _module_path(mod, unetpp)
        if coll == "batch_stats":
            t = state_dict[f"{prefix}.running_{leaf}"]
        elif mod[-1].startswith("BatchNorm_"):
            name = "weight" if leaf == "scale" else "bias"
            t = state_dict[f"{prefix}.{name}"]
        elif leaf == "kernel":
            t = state_dict[f"{prefix}.weight"].permute(2, 3, 1, 0)
        else:
            t = state_dict[f"{prefix}.bias"]
        a = t.detach().numpy().astype(np.float32)
        assert a.shape == s.shape, (keys, a.shape, s.shape)
        return a
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _trained(arch, seed):
    model = train_port_model(arch, seed=seed)
    jm = JAX_CLS[arch](encoder="resnet18", classes=1,
                       decoder_channels=TINY, dtype=jnp.float32,
                       fused_decoder=False)
    v = flax_variables(jm, model.state_dict())
    back = state_dict_from_flax(v["params"], v["batch_stats"])
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], t), key
    return model, jm, v


@pytest.fixture(scope="module")
def trained_unet():
    return _trained("unet", 0)


@pytest.fixture(scope="module")
def trained_unetpp():
    return _trained("unetpp", 1)


def _pick(request, arch):
    return request.getfixturevalue(
        "trained_unet" if arch == "unet" else "trained_unetpp")


def _calib(seed=2):
    rng = np.random.default_rng(seed)
    return [_blob_batch(rng, 4)[0] for _ in range(3)], _blob_batch(rng, 6)[0]


_JAX_TREES: dict = {}


def _jax_qtree(jm, v, calib, cdt):
    """JAX's engine in ``cdt`` and its tree from ``_calib()``'s batches:
    the tree does not depend on the compute dtype, so it is built once a
    model."""
    arch = "unetpp" if isinstance(jm, JaxUNetPP) else "unet"
    if arch not in _JAX_TREES:
        _JAX_TREES[arch] = jq.QuantizedUNet2D.from_model(
            jm, v, calib, jq.QuantConfig(mode="int8"))[1]
    eng = jq.QuantizedUNet2D(jm.encoder, jm.classes, jm.decoder_channels,
                             jq.QuantConfig(mode="int8", compute_dtype=cdt),
                             arch=arch)
    return eng, _JAX_TREES[arch]


def _port_tree_of(jax_tree, tmp_path):
    """A JAX-written artifact, as the port loads it."""
    path = str(tmp_path / "jax_q.npz")
    jq.save_qtree(path, jax_tree)
    return quant.load_qtree(path)


# ---------------------------------------------------------------------------
# The integer convolution
# ---------------------------------------------------------------------------

def test_int8_conv_exact_at_decoder_depth():
    """ResNet34's first decoder conv: K = 3*3*768. Inputs and weights in
    [-127, 127], most of them large and positive so that sums pass 2^24
    (where f32 stops holding integers), some of either sign: the int32
    sums equal int64 numpy's, and an f32-accumulating conv of the same
    integers does not."""
    rng = np.random.default_rng(0)
    x = rng.integers(90, 128, (2, 6, 5, 768))
    x[0, :, :, ::7] = rng.integers(-127, 128, x[0, :, :, ::7].shape)
    x[1] = -x[1]
    w = rng.integers(90, 128, (3, 3, 768, 16))
    w[..., ::5] = rng.integers(-127, 128, w[..., ::5].shape)
    x8, w8 = x.astype(np.int8), w.astype(np.int8)
    got = quant.int8_conv(torch.from_numpy(x8), torch.from_numpy(w8),
                          stride=1, pad=1).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((2, 6, 5, 16), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("nhwc,co->nhwo", xp[:, dy:dy + 6, dx:dx + 5],
                              w[dy, dx])
    assert got.dtype == np.int32
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got, want)
    f32 = F.conv2d(torch.from_numpy(x8).float().permute(0, 3, 1, 2),
                   torch.from_numpy(w8).float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1).double().numpy()
    assert not np.array_equal(f32, want)
    # strided, unpadded, a 1x1 kernel and a head of one channel
    for (kh, cin, cout, stride, pad) in ((7, 1, 8, 2, 3), (1, 16, 24, 2, 0),
                                         (3, 8, 1, 1, 1)):
        xs = rng.integers(-127, 128, (2, 9, 11, cin))
        ws = rng.integers(-127, 128, (kh, kh, cin, cout))
        got = quant.int8_conv(torch.from_numpy(xs.astype(np.int8)),
                              torch.from_numpy(ws.astype(np.int8)),
                              stride, pad).numpy()
        want = jax.lax.conv_general_dilated(
            jnp.asarray(xs.astype(np.int8)), jnp.asarray(ws.astype(np.int8)),
            (stride, stride), [(pad, pad), (pad, pad)],
            dimension_numbers=quant_dn(), preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got, np.asarray(want))


def quant_dn():
    return ("NHWC", "HWIO", "NHWC")


def test_nn_max_pool_int8_and_float():
    rng = np.random.default_rng(1)
    xi = rng.integers(-128, 128, (2, 9, 7, 3)).astype(np.int8)
    xf = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    for x in (xi, xf):
        got = quant.nn_max_pool(torch.from_numpy(x)).numpy()
        # JAX's int8 reduce_window refuses its own int32 init value, so the
        # reference pools the int8 values as int32
        want = np.asarray(jq.nn_max_pool(jnp.asarray(
            x.astype(np.int32) if x.dtype == np.int8 else x))).astype(x.dtype)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["unet", "unetpp"])
def test_int8_accumulators_match_jax(arch, request, tmp_path):
    """Every conv of an int8 forward on a JAX-written artifact: the port's
    int32 sums equal ``lax.conv_general_dilated(..., int32)`` of the same
    int8 input."""
    _, jm, v = _pick(request, arch)
    calib, x = _calib()
    jeng, jtree = _jax_qtree(jm, v, calib, jnp.float32)
    tree = _port_tree_of(jtree, tmp_path)
    eng = quant.QuantizedUNet2D("resnet18", 1, TINY,
                                quant.QuantConfig("int8", torch.float32),
                                arch=arch)
    seen = []
    real = quant.int8_conv

    def spy(xq, wq, stride=1, pad=0):
        out = real(xq, wq, stride, pad)
        seen.append((xq.numpy(), wq.numpy(), stride, pad, out.numpy()))
        return out
    quant.int8_conv = spy
    try:
        eng.apply(tree, nchw(x))
    finally:
        quant.int8_conv = real
    assert len(seen) == len(jtree)
    for xq, wq, stride, pad, got in seen:
        assert xq.dtype == np.int8 and wq.dtype == np.int8
        want = jax.lax.conv_general_dilated(
            jnp.asarray(xq), jnp.asarray(wq), (stride, stride),
            [(pad, pad), (pad, pad)], dimension_numbers=quant_dn(),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["unet", "unetpp"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_int8_logits_match_jax_apply(arch, cdt, request, tmp_path):
    """A JAX-written artifact through both engines: bit-equal logits, and
    the int8 mode never runs the folded path in its place."""
    _, jm, v = _pick(request, arch)
    calib, x = _calib()
    jeng, jtree = _jax_qtree(jm, v, calib, getattr(jnp, cdt))
    want = np.asarray(jeng.apply(jtree, jnp.asarray(x)))
    tree = _port_tree_of(jtree, tmp_path)
    eng = quant.QuantizedUNet2D(
        "resnet18", 1, TINY, quant.QuantConfig("int8", quant.DTYPES[cdt]),
        arch=arch)
    got = eng.apply(tree, nchw(x))
    assert got.dtype == torch.float32 and got.shape == (6, 1, HW, HW)
    np.testing.assert_array_equal(nhwc(got), want)
    folded = quant.QuantizedUNet2D(
        "resnet18", 1, TINY, quant.QuantConfig("folded", quant.DTYPES[cdt]),
        arch=arch).apply(tree, nchw(x))
    assert not torch.equal(folded, got)
    with pytest.raises(TypeError):
        eng.apply(eng.fold(_pick(request, arch)[0].state_dict()), nchw(x))


@pytest.mark.parametrize("arch,tol", [("unet", 1e-4), ("unetpp", 2e-4)])
def test_folded_matches_jax_apply_folded(arch, tol, request):
    model, jm, v = _pick(request, arch)
    _, x = _calib()
    jeng = jq.QuantizedUNet2D(jm.encoder, 1, TINY,
                              jq.QuantConfig("folded", jnp.float32),
                              arch=arch)
    want = np.asarray(jeng.apply_folded(jeng.fold(v), jnp.asarray(x)))
    eng = quant.QuantizedUNet2D("resnet18", 1, TINY,
                                quant.QuantConfig("folded", torch.float32),
                                arch=arch)
    folded = eng.fold(model.state_dict())
    got = eng.apply_folded(folded, nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=tol, atol=tol)
    with torch.no_grad():                   # the live model, BN unfolded
        np.testing.assert_allclose(got.numpy(), model(nchw(x)).numpy(),
                                   rtol=tol, atol=tol)
    # the folded mode of apply on a folded tree is apply_folded itself
    assert torch.equal(eng.apply(folded, nchw(x)), got)


@pytest.mark.parametrize("arch", ["unet", "unetpp"])
def test_from_model_matches_jax(arch, request):
    """The same weights and calibration batches through both builders."""
    model, jm, v = _pick(request, arch)
    calib, _ = _calib()
    _, jtree = _jax_qtree(jm, v, calib, jnp.bfloat16)
    eng, tree = quant.QuantizedUNet2D.from_model(
        model, [nchw(c) for c in calib],
        quant.QuantConfig("int8", torch.bfloat16))
    assert eng.arch == arch and set(tree) == set(jtree)
    off_by_one = 0
    for path, jleaf in jtree.items():
        leaf = tree[path]
        assert leaf["w_q"].dtype == torch.int8
        dq = leaf["w_q"].numpy().astype(int) - np.asarray(jleaf["w_q"])
        assert np.abs(dq).max() <= 1, path
        off_by_one += int(np.count_nonzero(dq))
        xs, jxs = float(leaf["x_scale"]), float(jleaf["x_scale"])
        assert abs(xs - jxs) <= 1e-6 * jxs, (path, xs, jxs)
        np.testing.assert_allclose(leaf["w_scale"].numpy(),
                                   np.asarray(jleaf["w_scale"]), rtol=1e-6)
        np.testing.assert_allclose(leaf["bias"].numpy(),
                                   np.asarray(jleaf["bias"]), rtol=1e-6,
                                   atol=1e-6)
    print(f"{arch}: {off_by_one} of "
          f"{sum(int(np.size(l['w_q'])) for l in jtree.values())} int8 "
          "weights off by one")
    assert off_by_one <= 8, off_by_one
    # the head keeps its own bias; the folded convs carry the BN shift
    assert tree["enc/Conv_0"]["bias"] is not None


def test_int8_prediction_agreement(trained_unet):
    """w8a8 predictions agree with f32 on the trained model."""
    model, _, _ = trained_unet
    calib, _ = _calib(3)
    eng, tree = quant.QuantizedUNet2D.from_model(
        model, [nchw(c) for c in calib],
        quant.QuantConfig("int8", torch.float32))
    x, _ = _blob_batch(np.random.default_rng(4), 6)
    with torch.no_grad():
        ref = model(nchw(x)).numpy()
    got = eng.apply(tree, nchw(x)).numpy()
    pm, rm = got > 0, ref > 0
    dice = 2.0 * (pm & rm).sum() / max(pm.sum() + rm.sum(), 1)
    assert dice >= 0.98, f"quantized/f32 prediction dice {dice}"
    conf = np.abs(ref) > 1.0
    corr = np.corrcoef(got[conf].ravel(), ref[conf].ravel())[0, 1]
    assert corr > 0.99, f"logit correlation {corr}"


# ---------------------------------------------------------------------------
# The artifact and the CLI
# ---------------------------------------------------------------------------

def _packs(root, n=1, s=6):
    """Packed volumes of blob slices (the packer's layout) and the list
    naming them."""
    rng = np.random.default_rng(7)
    paths = []
    for i in range(n):
        x, y = _blob_batch(rng, s)
        d = root / f"vol{i}"
        d.mkdir(parents=True)
        np.savez(d / "volume.npz", img=x.transpose(0, 3, 1, 2),
                 msk=y.astype(np.uint8))
        paths.append(str(d / "volume.npz"))
    lst = root / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def test_artifacts_load_in_either_package(tmp_path):
    """``cli.quantize`` of each package on the same weights of an ``amp``
    checkpoint (the port's and the JAX one, the CLIs' default decoder):
    both write the JAX layout with ``compute_dtype`` bfloat16, each
    package's ``load_engine`` reads the other's artifact, and an artifact
    gives the same int8 logits in either engine."""
    model = init_weights(build_unet("unet", "resnet18", classes=1),
                         torch.Generator().manual_seed(5)).eval()
    jm = JaxUNet(encoder="resnet18", classes=1)
    v = flax_variables(jm, model.state_dict())
    lst = _packs(tmp_path)
    args = {"model": "unet", "encoder": "resnet18", "k": 1, "classes": 1,
            "amp": True, "imagenet_norm": False}
    tck, jck = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    checkpoint.save_best(tck, model.state_dict(), args)
    jax_ckpt.save_best(jck, v["params"], v["batch_stats"], args)
    common = ["--list", lst, "--calib-batches", "1", "--calib-batch-size",
              "4"]
    assert quantize.main(["--ckpt", tck, "--out", str(tmp_path / "port_q"),
                          "--device", "cpu", *common]) == 0
    assert jax_quantize.main(["--ckpt", jck, "--out",
                              str(tmp_path / "jax_q.npz"), *common]) == 0
    port_meta = json.loads((tmp_path / "port_q.npz.meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax_q.npz.meta.json").read_text())
    drop = ("source_ckpt",)
    assert ({k: v for k, v in port_meta.items() if k not in drop}
            == {k: v for k, v in jax_meta.items() if k not in drop})
    assert port_meta["compute_dtype"] == "bfloat16"
    assert port_meta["mode"] == "int8" and port_meta["arch"] == "unet"
    x = _calib()[1][:2]
    for name in ("port_q", "jax_q"):
        teng, ttree, _ = quantize.load_engine(str(tmp_path / name))
        jeng, jtree, _ = jax_quantize.load_engine(str(tmp_path / name))
        assert teng.config.compute_dtype == torch.bfloat16
        assert set(ttree) == set(jtree)
        for path, leaf in jtree.items():
            assert ttree[path]["w_q"].dtype == torch.int8
            np.testing.assert_array_equal(ttree[path]["w_q"].numpy(),
                                          np.asarray(leaf["w_q"]))
        np.testing.assert_array_equal(
            nhwc(teng.apply(ttree, nchw(x))),
            np.asarray(jeng.apply(jtree, jnp.asarray(x))))
