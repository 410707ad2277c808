"""Parity of the PyTorch port's U-Net, Flax converter, checkpoint and
volume inference with the JAX package.

The JAX model's parameter tree comes from ``jax.eval_shape`` of its init,
filled with seeded numpy values (BatchNorm stats included, so eval mode is
not the identity), converted with ``state_dict_from_flax``, and both models
run the same NHWC/NCHW input. Logits agree to
max|d| <= 1e-4 * max|logit| + 1e-5 (f32 convolutions summed in another
order); the JAX model keeps its default ``fused_decoder=True``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_acl_imagesegmentation_adsp_tpu.infer import segment as jseg
from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.utils.imagenet import (
    make_input_norm as jax_norm)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer import (
    load_model_from_ckpt)
from mri_acl_imagesegmentation_adsp_tpu_torch.infer import segment
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.train import checkpoint
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.imagenet import (
    make_input_norm)

NARROW = (32, 16, 16, 8, 8)
DEFAULT = (256, 128, 64, 32, 16)


def jax_variables(model, hw, in_ch=1, seed=0):
    """Seeded numpy values in the shape of ``model.init``'s tree."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, in_ch)), train=True))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_logits_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, err


@pytest.mark.parametrize("encoder,decoder,hw", [
    ("resnet18", NARROW, 64),
    ("resnet34", DEFAULT, 32),      # the reference width: every key converts
    ("resnet50", NARROW, 32),
])
def test_converted_weights_give_jax_logits(encoder, decoder, hw):
    jm = jax_build("unet", encoder, "none", classes=2,
                   decoder_channels=decoder)
    v = jax_variables(jm, hw)
    x = np.random.default_rng(1).standard_normal(
        (2, hw, hw, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    tm = build_unet("unet", encoder, classes=2, decoder_channels=decoder)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert_logits_close(got.transpose(0, 2, 3, 1), want)


def test_converter_raises_on_unmatched_keys():
    v = jax_variables(jax_build("unet", "resnet18", "none",
                                decoder_channels=NARROW), 32)
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    with pytest.raises(KeyError):
        state_dict_from_flax(
            {**params, "Dense_0": {"kernel": np.zeros((2, 2))}}, stats)
    with pytest.raises(KeyError):
        state_dict_from_flax(params, {**stats, "BatchNorm_9": {
            "mean": np.zeros(2), "var": np.ones(2)}})
    enc_stats = dict(stats["ResNetEncoder_0"])
    del enc_stats["BatchNorm_0"]
    with pytest.raises(KeyError):
        state_dict_from_flax(params, {**stats, "ResNetEncoder_0": enc_stats})
    sd = state_dict_from_flax(params, stats)
    tm = build_unet("unet", "resnet34", decoder_channels=NARROW)
    with pytest.raises(RuntimeError):      # strict load: torch side
        tm.load_state_dict(sd)


def test_checkpoint_roundtrip_and_model_loading(tmp_path):
    tm = build_unet("unet", "resnet18")
    gen = torch.Generator().manual_seed(0)
    from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
        init_weights)
    init_weights(tm, gen)
    ckpt = str(tmp_path / "best.ckpt")
    args = {"model": "unet", "encoder": "resnet18", "k": 1, "classes": 1,
            "imagenet_norm": False}
    checkpoint.save_best(ckpt, tm.state_dict(), args)
    assert json.loads(open(ckpt + ".args.json").read()) == args
    loaded, got_args = load_model_from_ckpt(ckpt, device="cpu")
    assert got_args == args and not loaded.training
    x = torch.randn(2, 1, 32, 32, generator=gen)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(x).numpy(), tm.eval()(x).numpy())
    torch.save({"other": 1}, ckpt)
    with pytest.raises(ValueError):
        checkpoint.load_best(ckpt)


def test_imagenet_norm_matches_jax(rng):
    x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    want = np.asarray(jax_norm(True)(jnp.asarray(x)))
    got = make_input_norm(True)(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(x)
    assert make_input_norm(False)(t) is t


def test_segment_volume_2d_matches_jax(rng):
    """2.5-D stacks (k=3) through the same converted model: probabilities
    to 1e-5, and the on-device mask-only form equal to thresholding them."""
    jm = jax_build("unet", "resnet18", "none", in_ch=3,
                   decoder_channels=NARROW)
    v = jax_variables(jm, 32, in_ch=3)
    vol = rng.standard_normal((5, 32, 32)).astype(np.float32)
    want = np.asarray(jseg.segment_volume_2d(
        lambda x: jm.apply(v, x, train=False), vol, k=3, batch_size=2))
    np.testing.assert_array_equal(
        segment._neighbor_stack(torch.from_numpy(vol), 3).numpy(),
        np.asarray(jseg._neighbor_stack(jnp.asarray(vol), 3)
                   ).transpose(0, 3, 1, 2))
    tm = build_unet("unet", "resnet18", in_ch=3, decoder_channels=NARROW)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    tm.eval()
    probs = segment.segment_volume_2d(tm, torch.from_numpy(vol)[:, None],
                                      k=3, batch_size=2)
    assert probs.shape == (5, 1, 32, 32)
    np.testing.assert_allclose(probs.numpy(), want, rtol=1e-5, atol=1e-5)
    masks = segment.segment_volumes_2d(
        tm, [torch.from_numpy(vol), torch.from_numpy(vol[:2])], k=3,
        batch_size=4, masks_only_threshold=0.5)
    assert [m.shape for m in masks] == [(5, 32, 32), (2, 32, 32)]
    np.testing.assert_array_equal(masks[0].numpy(),
                                  (probs[:, 0] > 0.5).numpy().astype(np.uint8))
    with pytest.raises(ValueError):
        segment.segment_volume_2d(tm, torch.from_numpy(vol), k=2)


def test_build_unet_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(ValueError):
        build_unet("fpn")
    with pytest.raises(ValueError):
        build_unet("unet", "resnet101")
    with pytest.raises(ValueError):        # a download, as in the JAX factory
        build_unet("unet", "resnet34", encoder_weights="imagenet")
    weights = tmp_path / "resnet34.pt"
    torch.save({}, weights)     # a checkpoint imports, an empty one raises
    with pytest.raises(ValueError, match="lacks torchvision"):
        build_unet("unet", "resnet34", encoder_weights=str(weights))
