"""Parity of the PyTorch port's ConvNeXt, its Flax converter, the class-
weighted BCE and the classifier's optimizers with the JAX package.

The JAX ``ConvNeXt`` (tiny: depths 3/3/9/3, dims 96-768) gets seeded numpy
weights of order one (``jax.eval_shape`` gives the tree; no Flax init
runs), so that every block moves the logits: Flax's own init puts the
layer scales at 1e-6, which hides the blocks. The weights are carried to
the port by ``models/convert.py:state_dict_from_flax_convnext``; inputs
are seeded numpy, batch 2, at 32x32 (1-channel stem) and 50x70 (2-channel
stem, where Flax's "SAME" pads a stride-2 conv (0, 1)). Tolerances:
- forward f32: within 1e-4 of the largest |logit|;
- forward bf16 (``amp``): within 16 bf16 spacings at the largest |logit|;
- weighted BCE and its gradient: within 1e-6;
- optimizers (AdamW, the AMSGrad chain, SGD with momentum), 3 steps of the
  same random parameter and gradient trees as optax, no model: every
  parameter within 1e-6 of its tensor's largest |value|.
Each of three traps fails a test when put back: the erf GELU, symmetric
padding of the strided convs, and torch's AMSGrad (``torch.optim.AdamW(
amsgrad=True)``, the max of the raw second moment).
"""
import io
import threading
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mri_acl_imagesegmentation_adsp_tpu.classify import dataset as jds
from mri_acl_imagesegmentation_adsp_tpu.classify import trainer as jtr
from mri_acl_imagesegmentation_adsp_tpu.cli import serve as jserve
from mri_acl_imagesegmentation_adsp_tpu.models import convnext as jcx
from mri_acl_imagesegmentation_adsp_tpu.train import checkpoint as jckpt
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import (
    dataset as tds)
from mri_acl_imagesegmentation_adsp_tpu_torch.classify import (
    trainer as ttr)
from mri_acl_imagesegmentation_adsp_tpu_torch.cli import serve
from mri_acl_imagesegmentation_adsp_tpu_torch.models import convnext
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_convnext)
from mri_acl_imagesegmentation_adsp_tpu_torch.train.checkpoint import (
    save_best)

F32_RTOL = 1e-4
BF16_SPACINGS = 16
BCE_TOL = 1e-6
OPT_RTOL = 1e-6
CASES = {"32x32": (32, 32, 1), "50x70": (50, 70, 2)}


def _params(model, x, seed):
    """Seeded numpy weights of order one for the JAX module's tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape) / np.sqrt(fan_in)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "layer_scale":
            return 0.5 * rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(leaf(p, s), jnp.float32), shapes)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the input (NHWC), the JAX params and its f32 logits; and
    the bf16 logits at 32x32."""
    out = {}
    for name, (h, w, c) in CASES.items():
        x = np.random.default_rng(h).standard_normal(
            (2, h, w, c)).astype(np.float32)
        model = jcx.ConvNeXt(variant="tiny", in_chans=c)
        params = _params(model, x, seed=w)
        fwd = jax.jit(lambda p, x, m=model: m.apply({"params": p}, x))
        out[name] = (x, params, np.asarray(fwd(params, x)))
    x, params, _ = out["32x32"]
    model = jcx.ConvNeXt(variant="tiny", in_chans=1, dtype=jnp.bfloat16)
    out["bf16"] = np.asarray(jax.jit(
        lambda p, x: model.apply({"params": p}, x))(params, x))
    return out


def _port(params, in_chans, dtype=torch.float32):
    model = convnext.ConvNeXt("tiny", in_chans, dtype=dtype)
    model.load_state_dict(state_dict_from_flax_convnext(
        jax.tree_util.tree_map(np.asarray, params)))
    return model.eval()


def _logits(model, x_nhwc):
    with torch.no_grad():
        return model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_f32_matches_jax(jax_runs, case):
    x, params, want = jax_runs[case]
    got = _logits(_port(params, CASES[case][2]), x)
    assert got.shape == want.shape == (2, 1) and got.dtype == np.float32
    assert _rel(got, want) <= F32_RTOL, _rel(got, want)


def test_forward_bf16_within_spacings(jax_runs):
    x, params, _ = jax_runs["32x32"]
    want = jax_runs["bf16"]
    got = _logits(_port(params, 1, torch.bfloat16), x)
    assert got.dtype == np.float32
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= BF16_SPACINGS * spacing, (
        np.abs(got - want).max() / spacing)


def test_amp_daemon_reply_matches_jax_runner(jax_runs, tmp_path):
    """An ``amp`` checkpoint behind ``--task classify`` computes in bf16,
    and its reply is JAX's ``_ClassifyRunner``'s on the same weights
    within the bf16 gate: the sigmoid moves a probability by at most a
    quarter of the logit's move, so 16 spacings at the largest |logit|
    become 4 on the probabilities."""
    x, params, _ = jax_runs["32x32"]
    x = x[..., 0]                       # (N, H, W): the 1-channel form
    margs = {"model": "tiny", "diff": False, "amp": True}
    jckpt.save_best(str(tmp_path / "j.ckpt"), params, {}, margs)
    want = jserve._ClassifyRunner(str(tmp_path / "j.ckpt")).classify(
        x)["probs"]
    ckpt = str(tmp_path / "classifier_best.ckpt")
    save_best(ckpt, state_dict_from_flax_convnext(
        jax.tree_util.tree_map(np.asarray, params)), margs)
    server = serve.create_server(SimpleNamespace(
        task="classify", ckpt=ckpt, host="127.0.0.1", port=0, batch_size=4,
        warmup_shape="", device="cpu"))
    runner = server.RequestHandlerClass.runner
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    buf = io.BytesIO()
    np.savez(buf, x=x)
    try:
        with urllib.request.urlopen(urllib.request.Request(
                "http://127.0.0.1:%d/v1/classify" % server.server_address[1],
                data=buf.getvalue()), timeout=60) as r:
            with np.load(io.BytesIO(r.read())) as z:
                got = z["probs"]
    finally:
        server.shutdown()
        server.server_close()
        runner.close()
        thread.join(timeout=30)
    assert runner.compute_dtype == torch.bfloat16
    assert got.shape == want.shape == (2,) and got.dtype == np.float32
    spacing = 2.0 ** (np.floor(np.log2(np.abs(jax_runs["bf16"]).max())) - 7)
    assert np.abs(got - want).max() <= BF16_SPACINGS * spacing / 4, (
        got, want, spacing)


def test_erf_gelu_fails(jax_runs, monkeypatch):
    """The erf GELU (torch's default) is another model: it misses the f32
    gate (by 3.5e-4 of the largest |logit|; the port's own distance is
    about 2e-6)."""
    x, params, want = jax_runs["32x32"]
    monkeypatch.setattr(convnext, "_gelu", F.gelu)
    assert _rel(_logits(_port(params, 1), x), want) > F32_RTOL


def test_symmetric_padding_fails(jax_runs, monkeypatch):
    """Padding a strided conv's odd total symmetrically (as torch's
    ``padding=`` does) moves the window off Flax's."""
    x, params, want = jax_runs["50x70"]

    def symmetric(t, k, s):
        pads = []
        for n in (t.shape[-1], t.shape[-2]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [(total + 1) // 2] * 2
        return F.pad(t, pads)
    monkeypatch.setattr(convnext, "_pad_same", symmetric)
    got = _logits(_port(params, 2), x)
    assert got.shape == want.shape
    assert _rel(got, want) > F32_RTOL


def test_same_padding_and_dtypes():
    """Flax "SAME" by hand at the sizes the odd input meets; under bf16
    the blocks return f32 and the logits are f32."""
    pad = convnext._pad_same
    assert pad(torch.zeros(1, 1, 32, 32), 4, 4).shape[-2:] == (32, 32)
    t = pad(torch.ones(1, 1, 13, 18), 2, 2)
    assert t.shape[-2:] == (14, 18) and t[0, 0, -1].sum() == 0
    t = pad(torch.ones(1, 1, 51, 50), 4, 4)       # totals 1 and 2
    assert t.shape[-2:] == (52, 52)
    assert t[0, 0, -1].sum() == 0 and t[0, 0, 0].sum() == 50
    assert t[0, 0, :, 0].sum() == 0 and t[0, 0, :, -1].sum() == 0
    block = convnext.ConvNeXtBlock(8)
    assert block(torch.randn(1, 8, 4, 4).bfloat16(),
                 torch.bfloat16).dtype == torch.float32
    model = convnext.ConvNeXt("tiny", 1, dtype=torch.bfloat16)
    assert model(torch.randn(1, 1, 32, 32)).dtype == torch.float32


def test_converter_layout_and_strictness(jax_runs):
    _, params, _ = jax_runs["50x70"]
    sd = state_dict_from_flax_convnext(jax.tree_util.tree_map(np.asarray,
                                                              params))
    model = convnext.ConvNeXt("tiny", 2)
    assert set(sd) == set(model.state_dict())
    blk = params["ConvNeXtBlock_4"]           # stage 1, its second block
    np.testing.assert_array_equal(
        sd["stages.1.1.dwconv.weight"].numpy(),
        np.asarray(blk["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    assert sd["stages.1.1.dwconv.weight"].shape == (192, 1, 7, 7)
    np.testing.assert_array_equal(sd["stages.1.1.pwconv1.weight"].numpy(),
                                  np.asarray(blk["Dense_0"]["kernel"]).T)
    np.testing.assert_array_equal(sd["stages.1.1.gamma"].numpy(),
                                  np.asarray(blk["layer_scale"]))
    np.testing.assert_array_equal(
        sd["downsample.2.norm.weight"].numpy(),
        np.asarray(params["LayerNorm_3"]["scale"]))
    bad = {**params, "Extra_0": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(KeyError, match="Extra_0"):
        state_dict_from_flax_convnext(bad)


def test_init_and_factory():
    """Flax's init: kernels truncated normal at 2 std with std 0.02, zero
    biases, LayerNorm 1 / 0, layer scales 1e-6; the vendored factory."""
    model = convnext.init_convnext_weights(
        convnext.ConvNeXt("tiny", 1), torch.Generator().manual_seed(0))
    w = model.stages[2][0].pwconv1.weight.detach()
    assert abs(float(w.std()) - 0.02) < 0.001
    assert float(w.abs().max()) <= 2 * 0.02 / 0.87962566103423978
    assert float(model.head.bias.abs().max()) == 0.0
    assert float(model.stages[0][0].gamma.max()) == pytest.approx(1e-6)
    again = convnext.init_convnext_weights(
        convnext.ConvNeXt("tiny", 1), torch.Generator().manual_seed(0))
    assert torch.equal(w, again.stages[2][0].pwconv1.weight)
    m = convnext.ConvNext_model({"model_args": {"model": "tiny"}}, diff=True)
    assert m.in_chans == 2 and m.variant == "tiny"
    assert convnext.ConvNext_model(
        {"model_args": {"model": "convnext"}}).in_chans == 1
    with pytest.raises(ValueError, match="Wrong model selection"):
        convnext.ConvNext_model({"model_args": {"model": "resnet"}})
    with pytest.raises(ValueError, match="variant"):
        convnext.ConvNeXt("small")


def test_weighted_bce_and_gradient_match_jax():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal(16)).astype(np.float32)
    targets = (rng.random(16) > 0.6).astype(np.float32)
    weights = (0.4, 0.6)
    loss_j, grad_j = jax.value_and_grad(
        lambda z: jds.weighted_bce_loss(z, jnp.asarray(targets), weights))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    loss_t = tds.weighted_bce_loss(z, torch.from_numpy(targets), weights)
    (grad_t,) = torch.autograd.grad(loss_t, z)
    assert abs(float(loss_t) - float(loss_j)) <= BCE_TOL
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=0, atol=BCE_TOL)


OPTIMIZERS = {
    "adamw": dict(optimizer="adam", amsgrad=False),
    "amsgrad": dict(optimizer="adam", amsgrad=True),
    "sgd": dict(optimizer="sgd", amsgrad=False),
}


def _trees(seed):
    """A parameter tree and three gradient trees whose scale falls by step
    (so the AMSGrad maximum matters)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** -i).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]
    return params, grads


def _optax_run(args, params, grads):
    """The JAX trainer's own ``_make_tx``, under its inject_hyperparams."""
    tx = optax.inject_hyperparams(
        lambda learning_rate: jtr.ClassifierTrainer._make_tx(
            SimpleNamespace(args=args), learning_rate))(
        learning_rate=args.lr)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def _within(got, want):
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        if err > OPT_RTOL:
            return False
    return True


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_optax(name):
    args = ttr.ClassifierArgs(lr=1e-2, weight_decay=1e-2,
                              **OPTIMIZERS[name])
    params, grads = _trees(11)
    want = _optax_run(args, params, grads)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ttr.make_classifier_optimizer(args, list(tp.values()))
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in tp])
    got = {k: v.detach().numpy() for k, v in tp.items()}
    assert _within(got, want), name
    assert not _within(params, want)       # the steps moved something


def test_torch_amsgrad_is_another_optimizer():
    """``torch.optim.AdamW(amsgrad=True)`` keeps the max of the raw second
    moment; optax's chain, of the bias-corrected one."""
    args = ttr.ClassifierArgs(lr=1e-2, weight_decay=1e-2,
                              **OPTIMIZERS["amsgrad"])
    params, grads = _trees(11)
    want = _optax_run(args, params, grads)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(list(tp.values()), lr=args.lr,
                            weight_decay=args.weight_decay, amsgrad=True)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert not _within({k: v.detach().numpy() for k, v in tp.items()}, want)
