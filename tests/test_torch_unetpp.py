"""Parity of the PyTorch port's UNet++ with the JAX package's
(``models/unet2d.py:UNetPlusPlus``), the converter's UNet++ mapping and the
factory's ``validate_encoder_weights``.

The JAX tree is filled with seeded numpy values (``jax_variables``) and
converted with ``state_dict_from_flax`` under strict loading. The JAX
module's fused (phase-space) and plain decoders share one parameter tree;
the port has the plain form only, and a tree built by either converts to
the same port model. Tolerances: eval logits within 1e-4 * max|logit| +
1e-5; a train-mode forward's running stats within 1e-5 of each tensor's
max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import DEFAULT, NARROW, assert_logits_close, \
    jax_variables

from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.models.factory import (
    validate_encoder_weights as jax_validate)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
    load_model_from_ckpt)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet, validate_encoder_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    UNetPlusPlus)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint


def _jax_unetpp(encoder, decoder, fused, classes=1):
    return jax_build("unetpp", encoder, "none", classes=classes,
                     decoder_channels=decoder, fused_decoder=fused)


def _port(v, encoder="resnet18", decoder=NARROW, classes=1):
    tm = build_unet("unetpp", encoder, classes=classes,
                    decoder_channels=decoder)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return tm


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_unetpp_logits_match_jax(fused):
    """resnet18, narrow decoder, 64x64: a tree from the fused and from the
    plain JAX module gives the port's logits for both JAX lowerings."""
    jm = _jax_unetpp("resnet18", NARROW, fused, classes=2)
    v = jax_variables(jm, 64, seed=1)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    tm = _port(v, classes=2).eval()
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    for jax_fused in (False, True):
        other = _jax_unetpp("resnet18", NARROW, jax_fused, classes=2)
        want = np.asarray(jax.jit(lambda v, x: other.apply(
            v, x, train=False))(v, jnp.asarray(x)))
        assert_logits_close(got, want)


def test_unetpp_reference_width_converts_every_key():
    """resnet34 and the default decoder (256, 128, 64, 32, 16) at 32x32."""
    jm = _jax_unetpp("resnet34", DEFAULT, True)
    v = jax_variables(jm, 32, seed=2)
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    tm = _port(v, "resnet34", DEFAULT).eval()
    with torch.no_grad():
        got = tm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert_logits_close(got, want)
    assert len(tm.nodes) == 10 and tm.head.bias is not None


def test_unetpp_train_mode_batchnorm_matches_jax():
    jm = _jax_unetpp("resnet18", NARROW, False)
    v = jax_variables(jm, 64, seed=3)
    x = np.random.default_rng(3).standard_normal((4, 64, 64, 1)).astype(
        np.float32)
    logits, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = _port(v).train()
    got = tm(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    err = np.abs(got - np.asarray(logits)).max()
    assert err <= 1e-5 * np.abs(np.asarray(logits)).max() + 1e-6, err
    want = state_dict_from_flax(v["params"], upd["batch_stats"])
    bufs = dict(tm.named_buffers())
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (20 + 2 + 20)   # encoder + nodes + tail
    for n in names:
        w = want[n].numpy()
        d = np.abs(bufs[n].numpy() - w).max()
        assert d <= 1e-5 * max(np.abs(w).max(), 1e-30), (n, d)


def test_unetpp_converter_raises_on_unmatched_keys():
    v = jax_variables(_jax_unetpp("resnet18", NARROW, False), 64)
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    with pytest.raises(KeyError):
        state_dict_from_flax({**params, "Conv_23": params["Conv_22"]}, stats)
    with pytest.raises(KeyError):
        state_dict_from_flax({**params, "_DecoderBlock_0": {
            "Conv_0": params["Conv_0"]}}, stats)
    del stats["BatchNorm_21"]
    with pytest.raises(KeyError):
        state_dict_from_flax(params, stats)
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    with pytest.raises(RuntimeError):          # strict load: torch side
        build_unet("unet", "resnet18", decoder_channels=NARROW
                   ).load_state_dict(sd)


def test_unetpp_node_order_is_the_jax_call_order():
    assert UNetPlusPlus.node_order() == [
        (1, 0), (1, 1), (1, 2), (1, 3), (2, 0), (2, 1), (2, 2), (3, 0),
        (3, 1), (4, 0)]


def test_unetpp_checkpoint_loads_for_inference(tmp_path):
    tm = build_unet("unetplusplus", "resnet18", decoder_channels=DEFAULT)
    ckpt = str(tmp_path / "best.ckpt")
    checkpoint.save_best(ckpt, tm.state_dict(), {
        "model": "unetpp", "encoder": "resnet18", "k": 1, "classes": 1})
    loaded, args = load_model_from_ckpt(ckpt, device="cpu")
    assert isinstance(loaded, UNetPlusPlus) and args["model"] == "unetpp"
    x = torch.randn(1, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(x).numpy(),
                                      tm.eval()(x).numpy())


@pytest.mark.parametrize("value", ["none", "NULL", "imagenet",
                                   "/nonexistent/resnet.pt", "existing"])
def test_validate_encoder_weights_matches_jax(tmp_path, value):
    if value == "existing":
        value = str(tmp_path / "resnet.pt")
        torch.save({}, value)
    try:
        want = jax_validate(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_encoder_weights(value)
        assert str(got.value) == str(e)
        return
    assert validate_encoder_weights(value) == want
    if want is not None:       # an empty file holds no ResNet to import
        with pytest.raises(ValueError, match="lacks torchvision"):
            build_unet("unetpp", encoder_weights=value)


def test_launcher_trains_unetpp(tmp_path):
    """``--model unetpp`` through the launcher: one epoch on the CPU writes
    a best checkpoint that rebuilds as a UNet++."""
    from test_torch_train import _launch, _packs
    _packs(tmp_path / "art")
    assert _launch(tmp_path, "--no-amp", "--model", "unetpp") == 0
    model, args = load_model_from_ckpt(str(tmp_path / "run" / "best.ckpt"),
                                       device="cpu")
    assert isinstance(model, UNetPlusPlus) and args["model"] == "unetpp"
