"""Encoder weights from a torch ResNet checkpoint: the PyTorch port's
``models/torch_import.py`` and ``encoder_weights`` in ``models/factory.py``
and the trainer, held against the JAX package's ``apply_encoder_weights``.

A seeded torchvision-layout ``state_dict``
(``utils/synthetic.py:torchvision_resnet_state_dict``) goes through the
JAX importer into a Flax tree and on through ``state_dict_from_flax``, and
separately through the port's importer: the encoder tensors are bit-equal
(tolerance 0), for a 1-channel model (the stem summed over the file's
three channels) and a 3-channel one. The imported encoder's stages equal
the torchvision-faithful oracle of ``tests/test_torch_import.py`` to
1e-5 relative to each stage's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_import import _TResNetEncoder
from test_torch_quant import one_thread  # noqa: F401

from mri_acl_imagesegmentation_adsp_tpu.models import build_unet as jax_build
from mri_acl_imagesegmentation_adsp_tpu.models.torch_import import (
    apply_encoder_weights as jax_apply)
from mri_acl_imagesegmentation_adsp_tpu.train.engine import TrainState
from mri_acl_imagesegmentation_adsp_tpu_torch.models import torch_import
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import build_unet
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    RESNET_CFG, init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.trainer import (
    UNet2DArgs, UNet2DTrainer)
from mri_acl_imagesegmentation_adsp_tpu_torch.utils.synthetic import (
    torchvision_resnet_state_dict)


def _save(path, encoder, wrap, seed=0):
    sd = {k: torch.from_numpy(v) for k, v in
          torchvision_resnet_state_dict(encoder, seed).items()}
    if wrap:                    # an smp checkpoint: prefixed and wrapped
        sd = {"state_dict": {f"encoder.{k}": v for k, v in sd.items()}}
    torch.save(sd, path)
    return str(path)


def _jax_encoder(path, encoder, in_ch):
    """JAX's import into a zero U-Net state, as the port's state_dict."""
    jm = jax_build("unet", encoder, "none", classes=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, in_ch)), train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    state = jax_apply(TrainState(zeros["params"], zeros["batch_stats"],
                                 None, jnp.int32(0)), path, encoder)
    sd = state_dict_from_flax(state.params, state.batch_stats)
    return {k: v for k, v in sd.items() if k.startswith("encoder.")
            and not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("encoder,in_ch,wrap", [
    ("resnet18", 1, True), ("resnet34", 1, False), ("resnet34", 3, True),
    ("resnet50", 1, True)])
def test_import_is_bit_equal_to_jax(tmp_path, encoder, in_ch, wrap):
    path = _save(tmp_path / "enc.pt", encoder, wrap)
    want = _jax_encoder(path, encoder, in_ch)
    model = build_unet("unet", encoder, path, in_ch=in_ch)
    got = {f"encoder.{k}": v for k, v in model.encoder.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert got["encoder.stem_conv.weight"].shape[1] == in_ch


@pytest.mark.parametrize("encoder", ["resnet18", "resnet50"])
def test_imported_encoder_matches_torchvision_forward(tmp_path, encoder):
    path = _save(tmp_path / "enc.pt", encoder, False, seed=3)
    blocks, bottleneck = RESNET_CFG[encoder]
    oracle = _TResNetEncoder(blocks, bottleneck, in_ch=3)
    oracle.load_state_dict({k: v for k, v in torch.load(
        path, weights_only=True).items() if not k.startswith("fc.")})
    model = build_unet("unet", encoder, path, in_ch=3).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = oracle.eval().forward_stages(x)
        got = model.encoder(x)[1:]
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err


def test_trainer_imports_before_the_first_step(tmp_path):
    """``--encoder-weights``: after the trainer's seeded init the encoder
    holds the file's values, the decoder and head the init's."""
    path = _save(tmp_path / "enc.pt", "resnet18", True)
    rng = np.random.default_rng(0)
    (tmp_path / "vol").mkdir()
    np.savez(tmp_path / "vol" / "volume.npz",
             img=rng.standard_normal((4, 1, 32, 32)).astype(np.float32),
             msk=(rng.random((4, 32, 32)) > 0.5).astype(np.uint8))
    lst = tmp_path / "list.txt"
    lst.write_text(str(tmp_path / "vol" / "volume.npz"))

    def trainer(name, ew):
        return UNet2DTrainer(UNet2DArgs(
            train_list=str(lst), val_list=str(lst), encoder="resnet18",
            out_dir=str(tmp_path / name), encoder_weights=ew, workers=0,
            logger="noop"), device="cpu")
    t = trainer("pre", path)
    fresh = trainer("fresh", "none")
    want = build_unet("unet", "resnet18", path).encoder.state_dict()
    for k, v in t.model.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    for (k, v), (_, f) in zip(t.model.named_parameters(),
                              fresh.model.named_parameters()):
        assert torch.equal(v, f) != k.startswith("encoder."), k


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="imagenet"):
        build_unet("unet", "resnet34", "imagenet")
    with pytest.raises(ValueError, match="neither"):
        build_unet("unet", "resnet34", str(tmp_path / "missing.pt"))
    pickled = tmp_path / "module.pt"
    torch.save(init_weights(build_unet("unet", "resnet18"),
                            torch.Generator().manual_seed(0)), pickled)
    with pytest.raises(Exception, match="[Ww]eights only"):
        build_unet("unet", "resnet18", str(pickled))
    empty = tmp_path / "empty.pt"
    torch.save({}, empty)
    with pytest.raises(ValueError, match="lacks torchvision"):
        build_unet("unet", "resnet18", str(empty))
    r18 = _save(tmp_path / "r18.pt", "resnet18", False)
    with pytest.raises(ValueError, match="lacks layer1.2"):
        build_unet("unet", "resnet34", r18)
    wide = _save(tmp_path / "r50.pt", "resnet50", False)
    with pytest.raises(ValueError):
        torch_import.apply_encoder_weights(
            build_unet("unet", "resnet50", in_ch=5), wide, "resnet50")
