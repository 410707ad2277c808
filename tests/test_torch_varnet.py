"""Parity of the PyTorch port's VarNet models with the JAX package: the masks
and transforms, ``FastMRIUnet``, ``NormUnet``, ``SensitivityModel``,
``sens_reduce`` / ``sens_expand``, ``VarNetBlock``, ``VarNet`` in f32 and
bf16, the converter on the committed checkpoint, the SSIM loss, the recon
metrics and the synthetic VarNet data.

Both packages get the same seeded numpy inputs at narrow widths (1-2
cascades, ``chans`` 4, 2 pools, 2-3 coils, 16-32 pixels a side). The JAX
modules are initialized through a seeded numpy kernel initializer in place
of ``he_normal`` (whose per-shape compiles take tens of seconds op by op)
under ``jax.jit``, their norm scales and biases and ``dc_weight`` then
drawn at random so that the converter's every mapping shows, and the values
carried to the port by ``models/convert.py``. Tolerances, each stated where
it is checked:
- masks, transforms and the synthetic data: bit-equal;
- f32 modules and ``VarNet`` (JAX at its shipped ``phase_max_chans=36`` and
  at 0): within ``F32_RTOL`` of the output's largest magnitude;
- bf16 ``VarNet``: within ``BF16_SPACINGS`` bf16 spacings at the largest
  magnitude of JAX's bf16 run; each side is also measured against a
  float64 run of the port with the same weights;
- the committed checkpoint converted: within ``F32_RTOL`` of the maximum;
- the SSIM loss and SSIM: within 1e-6 (the window means are ``avg_pool2d``
  here, a 1/49-weighted convolution there); MSE / NMSE / PSNR bit-equal.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mri_acl_imagesegmentation_adsp_tpu.data import subsample as jsub
from mri_acl_imagesegmentation_adsp_tpu.data import transforms as jtf
from mri_acl_imagesegmentation_adsp_tpu.metrics import recon_eval as jre
from mri_acl_imagesegmentation_adsp_tpu.models import fastmri_unet as jfm
from mri_acl_imagesegmentation_adsp_tpu.recon import varnet as jvn
from mri_acl_imagesegmentation_adsp_tpu.train import ssim as jssim
from mri_acl_imagesegmentation_adsp_tpu.train import varnet_trainer as jvt
from mri_acl_imagesegmentation_adsp_tpu_torch.data import subsample as tsub
from mri_acl_imagesegmentation_adsp_tpu_torch.data import transforms as ttf
from mri_acl_imagesegmentation_adsp_tpu_torch.metrics import recon_eval as tre
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_fastmri_unet, state_dict_from_flax_varnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
    FastMRIUnet)
from mri_acl_imagesegmentation_adsp_tpu_torch.parallel import mesh
from mri_acl_imagesegmentation_adsp_tpu_torch.recon import varnet as tvn
from mri_acl_imagesegmentation_adsp_tpu_torch.tools import varnet_synthetic
from mri_acl_imagesegmentation_adsp_tpu_torch.train import ssim as tssim
from mri_acl_imagesegmentation_adsp_tpu_torch.train import (
    varnet_trainer as tvt)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_RTOL = 5e-5       # f32 outputs, times the output's max |value|
BF16_SPACINGS = 16    # bf16 VarNet, in bf16 spacings at its max |value|
KEY = jax.random.PRNGKey(0)


_INIT = {"rng": np.random.default_rng(11)}


def _reset_init(seed: int) -> None:
    """Restart the JAX kernels' numpy stream, so that a model's weights do
    not depend on which tests ran before it."""
    _INIT["rng"] = np.random.default_rng(seed)


@pytest.fixture(scope="module", autouse=True)
def np_init():
    """A seeded numpy He-normal kernel initializer for the JAX modules."""
    def init(key, shape, dtype=jnp.float32):
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((_INIT["rng"].standard_normal(shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32))
    old = jfm._conv_init
    jfm._conv_init = init
    yield
    jfm._conv_init = old


def _params(module, seed: int, *args):
    """``module``'s parameters for ``args``: kernels from the numpy stream
    restarted at ``seed``, the rest by :func:`_randomized`."""
    _reset_init(seed)
    return _randomized(jax.jit(module.init)(KEY, *args)["params"], seed)


def _randomized(params, seed: int):
    """The tree with every norm scale / bias, conv bias and ``dc_weight``
    drawn at random (kernels kept)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
        if name == "bias":
            return (0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
        if name == "dc_weight":
            return (0.5 + rng.random(v.shape)).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(leaf, params)


def _apply(module, params, *args):
    """``module.apply`` jitted and compiled at XLA's lowest backend
    optimization level (half the CPU compile time), then run."""
    v = {"params": params}
    return np.asarray(jax.jit(module.apply).lower(v, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(v, *args))


def _pair(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# ---------------------------------------------------------------------------
# Masks, transforms, synthetic data: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["RandomMaskFunc", "EquispacedMaskFunc"])
@pytest.mark.parametrize("shape", [(4, 32, 30, 2), (2, 1, 24, 37, 2)])
def test_masks_bit_equal(cls, shape):
    kw = dict(center_fractions=[0.08, 0.04], accelerations=[4, 8])
    jm, tm = getattr(jsub, cls)(**kw), getattr(tsub, cls)(**kw)
    for seed in (0, 1, 1234, None):
        if seed is None:
            seed = tsub.seed_from_filename("file1000.h5")
            assert seed == jsub.seed_from_filename("file1000.h5")
        np.testing.assert_array_equal(tm(shape, seed), jm(shape, seed))
    k = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for a, b in zip(tsub.apply_mask(k, tm, 5), jsub.apply_mask(k, jm, 5)):
        np.testing.assert_array_equal(a, b)
    kc = k[..., 0] + 1j * k[..., 1]
    for a, b in zip(tsub.apply_mask(kc, tm, 5), jsub.apply_mask(kc, jm, 5)):
        np.testing.assert_array_equal(a, b)


def test_transforms_bit_equal():
    rng = np.random.default_rng(3)
    c = (rng.standard_normal((3, 2, 20, 17))
         + 1j * rng.standard_normal((3, 2, 20, 17))).astype(np.complex64)
    np.testing.assert_array_equal(ttf.to_tensor(c), jtf.to_tensor(c))
    p = ttf.to_tensor(c)
    np.testing.assert_array_equal(ttf.tensor_to_complex_np(p),
                                  jtf.tensor_to_complex_np(p))
    x = rng.standard_normal((2, 21, 18)).astype(np.float32)
    for shape in ((21, 18), (10, 7), (1, 1)):
        np.testing.assert_array_equal(ttf.center_crop(x, shape),
                                      jtf.center_crop(x, shape))
    for shape in ((20, 17), (9, 8), (1, 1)):
        np.testing.assert_array_equal(ttf.complex_center_crop(p, shape),
                                      jtf.complex_center_crop(p, shape))
    y = rng.standard_normal((19, 22)).astype(np.float32)
    for a, b in zip(ttf.center_crop_to_smallest(x, y),
                    jtf.center_crop_to_smallest(x, y)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttf.normalize_instance(x, 1e-11),
                    jtf.normalize_instance(x, 1e-11)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ttf.center_crop(x, (22, 18))
    attrs = {"max": 2.5, "recon_size": (20, 17, 1)}
    esp = c[:, :1]
    for mask in (None, tsub.EquispacedMaskFunc([0.1], [4])):
        jmask = None if mask is None else jsub.EquispacedMaskFunc([0.1], [4])
        got = ttf.VarNetDataTransform(mask)(c, np.abs(c[0, 0]), esp, attrs,
                                            "f.h5", 3)
        want = jtf.VarNetDataTransform(jmask)(c, np.abs(c[0, 0]), esp, attrs,
                                              "f.h5", 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = ttf.VarNetDataTransform()(c, None, esp, attrs, "f.h5", 0)
    assert got.max_value == 0.0 and got.target.shape == ()


def _load_script(name: str, monkeypatch):
    monkeypatch.setenv("MRI_TPU_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("recipe,split", [("synthetic", "train"),
                                          ("synthetic", "val"),
                                          ("protocol", "val")])
def test_synthetic_data_bit_equal_to_scripts(recipe, split, monkeypatch):
    """The port's in-memory recipes against the JAX scripts' generators:
    every array and field equal, the zero-filled baselines too."""
    spec = varnet_synthetic.RECIPES[recipe][split]
    got, got_zf = varnet_synthetic.make_samples(recipe, split)
    if recipe == "synthetic":
        mod = _load_script("train_varnet_synthetic", monkeypatch)
        want, want_zf = mod.make_samples(spec["n_vols"], spec["slices"],
                                         spec["seed"], spec["tag"])
        for a, b in zip(got_zf, want_zf):
            np.testing.assert_array_equal(a, b)
    else:
        mod = _load_script("train_varnet_protocol", monkeypatch)
        want = mod.make_samples(spec["n"], spec["seed"], spec["tag"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_gain_fitted_nmse_removes_only_a_global_scale():
    """A prediction off by a global gain has a gain-fitted NMSE of zero and
    that gain's inverse; one off by noise keeps its error (within 1e-6)."""
    rng = np.random.default_rng(9)
    t = (0.1 + rng.random((1, 12, 10))).astype(np.float32)
    got = varnet_synthetic.gain_fitted([(t, 0.8 * t), (t, t)])
    assert got["gain"] == pytest.approx((1.25 + 1.0) / 2, rel=1e-6)
    assert got["nmse_gain_fitted"] <= 1e-12
    noisy = t + 0.05 * rng.standard_normal(t.shape).astype(np.float32)
    fit = varnet_synthetic.gain_fitted([(t, noisy)])
    assert 0 < fit["nmse_gain_fitted"] <= varnet_synthetic.nmse(t, noisy)
    assert fit["nmse_gain_fitted"] >= 0.5 * varnet_synthetic.nmse(t, noisy)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pmc", [36, 0])
def test_fastmri_unet_odd_sizes_matches_jax(pmc):
    """21x19 reflect-pads to 24x20 and crops back; the random transpose
    kernels are asymmetric, so a conversion without the flip fails."""
    x = _pair(np.random.default_rng(4), (2, 21, 19, 3))
    jm = jfm.FastMRIUnet(out_chans=2, chans=4, num_pool_layers=2,
                         phase_max_chans=pmc)
    params = _params(jm, 1, x)
    want = _apply(jm, params, x)
    tm = FastMRIUnet(3, 2, 4, 2)
    sd = state_dict_from_flax_fastmri_unet(params)
    tm.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 21, 19, 2)
    assert _rel(got, want) < F32_RTOL
    # the mutation: the transpose kernels carried unflipped
    bad = {k: (v.flip(2, 3) if k.endswith("tconv.weight") else v)
           for k, v in sd.items()}
    tm.load_state_dict(bad)
    with torch.no_grad():
        off = tm(xt).permute(0, 2, 3, 1).numpy()
    assert _rel(off, want) > 100 * F32_RTOL


def test_reflect_pad_longer_than_the_axis_matches_numpy():
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.fastmri_unet import (
        reflect_pad_end)
    x = np.arange(2 * 3 * 5, dtype=np.float32).reshape(1, 2, 3, 5)
    got = reflect_pad_end(torch.from_numpy(x), 7, 9).numpy()
    want = np.pad(x, ((0, 0), (0, 0), (0, 7), (0, 9)), mode="reflect")
    np.testing.assert_array_equal(got, want)


def test_normunet_matches_jax():
    """Pair entries (6-D and 5-D) and the SoA entry, over 2 coils x 3
    averages: the channel order, the ddof=1 norm and the centred pad."""
    rng = np.random.default_rng(5)
    x = _pair(rng, (2, 2, 3, 20, 18, 2))
    jm = jvn.NormUnet(chans=4, num_pools=2)
    params = _params(jm, 2, x)
    tm = tvn.NormUnet(4, 2, in_chans=12)
    tm.load_state_dict({f"unet.{k}": v for k, v in
                        state_dict_from_flax_fastmri_unet(
                            params["FastMRIUnet_0"]).items()})
    want = _apply(jm, params, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        gr, gi = tm(torch.from_numpy(x[..., 0]), torch.from_numpy(x[..., 1]))
    assert _rel(got, want) < F32_RTOL
    np.testing.assert_array_equal(np.stack([gr, gi], -1), got)
    x5 = x[:, :, 0]                     # (b, c, h, w, 2): one average
    jm5 = jvn.NormUnet(chans=4, num_pools=2)
    p5 = _params(jm5, 3, x5)
    tm5 = tvn.NormUnet(4, 2, in_chans=4)
    tm5.load_state_dict({f"unet.{k}": v for k, v in
                         state_dict_from_flax_fastmri_unet(
                             p5["FastMRIUnet_0"]).items()})
    with torch.no_grad():
        got5 = tm5(torch.from_numpy(x5)).numpy()
    assert got5.shape == (2, 2, 1, 20, 18, 2)
    assert _rel(got5, _apply(jm5, p5, x5)) < F32_RTOL


@pytest.mark.parametrize("aves", [1, 2])
def test_sensitivity_model_matches_jax(aves):
    """Maps with one average (the dataset's layout) and with two."""
    e = _pair(np.random.default_rng(6), (2, 3, aves, 20, 18, 2))
    jm = jvn.SensitivityModel(chans=4, num_pools=2)
    params = _params(jm, 4, e)
    tm = tvn.SensitivityModel(4, 2, aves=aves)
    tm.load_state_dict({f"norm_unet.unet.{k}": v for k, v in
                        state_dict_from_flax_fastmri_unet(
                            params["NormUnet_0"]["FastMRIUnet_0"]).items()})
    want = _apply(jm, params, e)
    with torch.no_grad():
        got = tm(torch.from_numpy(e)).numpy()
    assert _rel(got, want) < F32_RTOL
    rss = np.sqrt((got ** 2).sum(axis=(1, 5)))
    np.testing.assert_allclose(rss, 1.0, atol=1e-5)


def test_sens_reduce_expand_match_jax_and_are_adjoint():
    rng = np.random.default_rng(7)
    k = _pair(rng, (2, 3, 2, 16, 20, 2))
    maps = _pair(rng, (2, 3, 1, 16, 20, 2))      # one average, broadcast
    img = _pair(rng, (2, 2, 16, 20, 2))
    red = tvn.sens_reduce(torch.from_numpy(k), torch.from_numpy(maps))
    exp = tvn.sens_expand(torch.from_numpy(img), torch.from_numpy(maps))
    assert _rel(red.numpy(), np.asarray(jvn.sens_reduce(k, maps))) < 1e-6
    assert _rel(exp.numpy(), np.asarray(jvn.sens_expand(img, maps))) < 1e-6
    # <S x, y> = <x, S^H y> (real inner product of the complex pairs), f64
    k64, m64, x64 = (torch.from_numpy(a.astype(np.float64))
                     for a in (k, maps, img))
    lhs = float((tvn.sens_expand(x64, m64) * k64).sum())
    rhs = float((x64 * tvn.sens_reduce(k64, m64)).sum())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def _k0_per_component(rng, shape):
    """k-space with some entries purely real, some purely imaginary and
    some zero: a complex ``k0 != 0`` mask would differ from the reference's
    per-component one there."""
    k = _pair(rng, shape)
    k[..., ::3, 0] = 0.0              # purely imaginary columns
    k[..., 1::3, 1] = 0.0             # purely real columns
    k[..., 5, :] = 0.0                # unsampled
    return k


def test_varnet_block_per_component_dc_matches_jax():
    rng = np.random.default_rng(8)
    k0 = _k0_per_component(rng, (2, 3, 2, 16, 18, 2))
    kk = k0 + 0.3 * _pair(rng, k0.shape)
    s = _pair(rng, (2, 3, 1, 16, 18, 2))
    parts = (kk[..., 0], kk[..., 1], k0[..., 0], k0[..., 1], s[..., 0],
             s[..., 1])
    assert ((k0[..., 0] == 0) & (k0[..., 1] != 0)).any()
    assert ((k0[..., 1] == 0) & (k0[..., 0] != 0)).any()
    jm = jvn.VarNetBlock(chans=4, pools=2, reg_in_chans=4)
    params = _params(jm, 5, *parts)
    want = np.moveaxis(_apply(jm, params, *parts), 0, -1)
    tm = tvn.VarNetBlock(4, 2, aves=2)
    sd = {f"norm_unet.unet.{k}": v for k, v in
          state_dict_from_flax_fastmri_unet(
              params["NormUnet_0"]["FastMRIUnet_0"]).items()}
    sd["dc_weight"] = torch.from_numpy(np.asarray(params["dc_weight"]))
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = np.stack(tm(*(torch.from_numpy(np.ascontiguousarray(p))
                             for p in parts)), -1)
    assert _rel(got, want) < F32_RTOL


@pytest.fixture(scope="module")
def varnet_case():
    """Inputs, the JAX VarNet's f32 parameters (1 cascade, chans 4, 2
    pools, sens_chans 4) and its outputs at phase_max_chans 36 and 0, and in
    bf16."""
    rng = np.random.default_rng(9)
    k = _k0_per_component(rng, (2, 3, 2, 20, 18, 2))
    e = _pair(rng, (2, 3, 1, 20, 18, 2))
    kw = dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2)
    m36 = jvn.VarNet(**kw)
    params = _params(m36, 6, k, e)
    out = {"f32_36": m36, "f32_0": jvn.VarNet(phase_max_chans=0, **kw),
           "bf16_36": jvn.VarNet(dtype=jnp.bfloat16, **kw)}
    out = {n: _apply(m, params, k, e) for n, m in out.items()}
    return k, e, params, out


def _port_varnet(params, dtype):
    m = tvn.VarNet(aves=2, sens_aves=1, num_cascades=1, sens_chans=4,
                   sens_pools=2, chans=4, pools=2, dtype=dtype)
    m.load_state_dict(state_dict_from_flax_varnet(params))
    return m.to(torch.float64) if dtype == torch.float64 else m


@pytest.mark.parametrize("pmc", [36, 0])
def test_varnet_f32_matches_jax(varnet_case, pmc):
    k, e, params, out = varnet_case
    with torch.no_grad():
        got = _port_varnet(params, torch.float32)(torch.from_numpy(k),
                                                  torch.from_numpy(e))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 20, 18)
    assert _rel(got.numpy(), out[f"f32_{pmc}"]) < F32_RTOL


def test_varnet_bf16_matches_jax_in_bf16_spacings(varnet_case):
    """The port's bf16 run against JAX's (its phase lowering at 36), in bf16
    spacings at the largest magnitude; both against a float64 run of the
    port with the same weights (printed: ROADMAP.md Queue 3 records which
    side is nearer)."""
    k, e, params, out = varnet_case
    kt, et = torch.from_numpy(k), torch.from_numpy(e)
    with torch.no_grad():
        got = _port_varnet(params, torch.bfloat16)(kt, et)
        ref = _port_varnet(params, torch.float64)(kt.double(), et.double())
    assert got.dtype == torch.float32
    want, ref = out["bf16_36"], ref.numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    port_jax = float(np.abs(got.numpy() - want).max()) / spacing
    port_f64 = float(np.abs(got.numpy() - ref).max()) / spacing
    jax_f64 = float(np.abs(want - ref).max()) / spacing
    print(f"bf16 spacings at max |out| {np.abs(want).max():.3f}: port-JAX "
          f"{port_jax:.2f}, port-f64 {port_f64:.2f}, JAX-f64 {jax_f64:.2f}")
    assert port_jax < BF16_SPACINGS
    assert port_f64 < BF16_SPACINGS and jax_f64 < BF16_SPACINGS


def test_varnet_pair_layouts_and_refusals():
    assert tvt.build_varnet_from_args({"bvalue": "b1000", "chans": 4,
                                       "num_cascades": 1}).aves == 12
    with pytest.raises(ValueError, match="aves"):
        tvt.build_varnet_from_args({"bvalue": "custom"})
    with pytest.raises(TypeError, match="ReconGrid"):
        tvt.build_varnet_from_args(tvt.VarNetArgs(), mesh=object())
    # a (1, 1) grid (one rank: no sub-groups) builds the one-device model
    one = mesh.ReconGrid(mesh.DataGroup(1, 0, torch.device("cpu"), None,
                                        "gloo"), None, None)
    kw = {"bvalue": "b50", "num_cascades": 1, "chans": 4, "pools": 2,
          "sens_chans": 4, "sens_pools": 2, "amp": False}
    on_grid = tvt.build_varnet_from_args(kw, mesh=one)
    plain = tvt.build_varnet_from_args(kw)
    plain.load_state_dict(on_grid.state_dict())
    rng = np.random.default_rng(4)
    k, e = (torch.from_numpy(_pair(rng, (1, 2, a, 16, 16, 2)))
            for a in (3, 1))
    with torch.no_grad():
        torch.testing.assert_close(on_grid(k, e), plain(k, e), rtol=0,
                                   atol=0)
    m = tvt.build_varnet_from_args({"bvalue": "b50", "num_cascades": 1,
                                    "chans": 4, "pools": 2, "sens_chans": 4,
                                    "sens_pools": 2, "amp": True})
    assert m.dtype == torch.bfloat16
    assert tvn.varnet_layout(m.state_dict()) == (3, 1)


def test_committed_checkpoint_converted_matches_jax():
    """``runs/varnet_synthetic/varnet_best.ckpt`` (4 cascades, chans 8, 3
    pools, f32) restored on the JAX side, converted, and both forwards on
    one of that run's validation slices (the recipe's own data)."""
    ckpt = ROOT / "runs" / "varnet_synthetic" / "varnet_best.ckpt"
    args = json.loads((ckpt.parent / (ckpt.name + ".args.json")).read_text())
    val, _ = varnet_synthetic.make_samples("synthetic", "val")
    k, e = val[3].kspace[None], val[3].espirit[None]
    params = serialization.msgpack_restore(ckpt.read_bytes())[
        "model"]["params"]
    # the plain lowering: it compiles in a third of the phase one's time,
    # and test_varnet_f32_matches_jax holds the two equal
    jm = jvt.build_varnet_from_args(args).clone(phase_max_chans=0)
    want = _apply(jm, params, k, e)
    tm = tvt.build_varnet_from_args(args, aves=1, sens_aves=1)
    tm.load_state_dict(state_dict_from_flax_varnet(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(k), torch.from_numpy(e)).numpy()
    assert _rel(got, want) < F32_RTOL
    # the trained net beats the zero-filled input on these slices
    assert np.mean((got[0, 0] - val[3].target) ** 2) < 0.5 * np.mean(
        val[3].target ** 2)


# ---------------------------------------------------------------------------
# Losses and metrics
# ---------------------------------------------------------------------------

def test_ssim_loss_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.random((3, 1, 20, 24)).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    dr = np.asarray([1.0, 1.5, 0.7], np.float32)
    want = float(jssim.ssim_loss(x, y, dr))
    got = float(tssim.ssim_loss(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(dr)))
    assert abs(got - want) < 1e-6
    wmap = np.asarray(jssim.ssim_loss(x, y, dr, reduced=False))
    gmap = tssim.ssim_loss(torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(dr), reduced=False).numpy()
    assert gmap.shape == wmap.shape == (3, 1, 14, 18)
    np.testing.assert_allclose(gmap, wmap, atol=1e-5)


def test_recon_metrics_match_jax():
    rng = np.random.default_rng(12)
    gt = rng.random((3, 24, 20)).astype(np.float32)
    pred = (gt + 0.05 * rng.standard_normal(gt.shape)).astype(np.float32)
    for name in ("mse", "nmse"):
        assert getattr(tre, name)(gt, pred) == getattr(jre, name)(gt, pred)
    assert tre.psnr(gt, pred) == jre.psnr(gt, pred)
    assert tre.psnr(gt, gt) == float("inf")
    assert abs(tre.ssim(gt, pred) - jre.ssim(gt, pred)) < 1e-6
    assert abs(tre.ssim(gt, pred, maxval=2.0)
               - jre.ssim(gt, pred, maxval=2.0)) < 1e-6
    assert abs(float(tre._ssim_2d(torch.from_numpy(gt[0]),
                                  torch.from_numpy(pred[0]), 1.0))
               - float(jre._ssim_2d(gt[0], pred[0], 1.0))) < 1e-6
    with pytest.raises(ValueError):
        tre.ssim(gt[0], pred[0])
    tm, jm = tre.Metrics(), jre.Metrics()
    for i in range(3):
        tm.push(gt[i:i + 1], pred[i:i + 1] * (1 + 0.1 * i))
        jm.push(gt[i:i + 1], pred[i:i + 1] * (1 + 0.1 * i))
    for a, b in ((tm.means(), jm.means()), (tm.stddevs(), jm.stddevs())):
        assert a.keys() == b.keys()
        for key in a:
            assert abs(a[key] - b[key]) <= 1e-6 * max(1.0, abs(b[key]))
    assert repr(tm).split()[0] == repr(jm).split()[0]
    from mri_acl_imagesegmentation_adsp_tpu_torch import metrics
    assert set(metrics.__all__) == set(
        __import__("mri_acl_imagesegmentation_adsp_tpu.metrics",
                   fromlist=["__all__"]).__all__)
