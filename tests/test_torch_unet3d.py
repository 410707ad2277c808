"""Parity of the PyTorch port's 3-D residual U-Net, its Flax converter and
the 3-D DiceCE losses with the JAX package, and the per-block remat of
both U-Nets.

The JAX parameter trees come from ``jax.eval_shape`` of the module's init
filled with seeded numpy values (so no JAX initializer compiles), carried
over by ``state_dict_from_flax_unet3d``. Narrow models, channels (4, 8,
16), so each JAX program compiles in a second or two.
Tolerances, each stated where it is checked:
- f32 logits: max|d| <= 1e-5 * max|logit| (convolutions summed in
  another order; the InstanceNorm's two-pass variance against Flax's
  one-pass ``E[x^2] - E[x]^2``, equal up to f32 rounding);
- gradients of the DiceCE loss: loss 1e-5 relative, each parameter's
  gradient within 1e-4 * its max|g|, plus 1e-6 of the largest gradient in
  the net for the conv biases ahead of an InstanceNorm, whose gradients
  are zero in exact arithmetic and rounding noise (1e-9) here;
- bf16 logits: within 8 bf16 spacings at the largest |logit| (the 2-D
  bound of ``tests/test_torch_infer.py``): both sides round each op to
  bf16, in different places;
- losses: values 1e-6 relative, logit gradients 1e-5 * max|g|;
- remat on and off: bit-equal on the CPU (3-D), and for the 2-D U-Net the
  losses, gradients and BatchNorm running statistics after two steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mri_acl_imagesegmentation_adsp_tpu.models import unet3d as junet3d
from mri_acl_imagesegmentation_adsp_tpu.train import losses as jlosses
from mri_acl_imagesegmentation_adsp_tpu_torch.models import unet3d
from mri_acl_imagesegmentation_adsp_tpu_torch.models.convert import (
    state_dict_from_flax_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.factory import (
    build_unet, build_unet3d)
from mri_acl_imagesegmentation_adsp_tpu_torch.models.unet2d import (
    init_weights)
from mri_acl_imagesegmentation_adsp_tpu_torch.train import losses
from mri_acl_imagesegmentation_adsp_tpu_torch.train.engine import Engine
from mri_acl_imagesegmentation_adsp_tpu_torch.train.optim import (
    make_optimizer)

CHANNELS = (4, 8, 16)
BF16_SPACINGS = 8


def flax_params(module, x_shape, seed=0):
    """Seeded numpy values in the shape of ``module.init``'s params."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "negative_slope":
            return np.float32(rng.uniform(0.01, 0.3))
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x[..., 0][:, None]))


def _port(params, dtype=torch.float32, remat=False, channels=CHANNELS):
    tm = build_unet3d(1, 1, channels, dtype=dtype, remat=remat)
    tm.load_state_dict(state_dict_from_flax_unet3d(params))
    return tm


def _close(got, want, rtol, name="", floor=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + floor, (name, err)
    return err


def _apply(jm, p, x, **kw):
    return np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x, **kw))(
        p, jnp.asarray(x)))


def _input(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, *shape, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_up", [True, False])
@pytest.mark.parametrize("shape", [(8, 12, 16), (4, 20, 8)],
                         ids=["odd_at_bottleneck", "odd_at_level1"])
def test_unet3d_logits_match_jax(fused_up, shape):
    """(8, 12, 16) halves to (4, 6, 8) and (2, 3, 4); (4, 20, 8) to (2,
    10, 4) and (1, 5, 2): odd sizes deep in the net. Both Flax lowerings of
    the transpose conv; a conversion without the kernel flip is off."""
    jm = junet3d.ResidualUNet3D(classes=1, channels=CHANNELS,
                                fused_up=fused_up)
    x = _input(shape)
    p = flax_params(jm, x.shape)
    want = _apply(jm, p, x)[..., 0]
    tm = _port(p)
    with torch.no_grad():
        got = tm(_ncdhw(x))[:, 0].numpy()
    _close(got, want, 1e-5, "logits")
    # the flip is load-bearing: the kernel as Flax stores it gives another
    # function
    sd = state_dict_from_flax_unet3d(p)
    for n in range(len(CHANNELS) - 1):
        sd[f"up.{n}.weight"] = sd[f"up.{n}.weight"].flip(2, 3, 4)
    tm.load_state_dict(sd)
    with torch.no_grad():
        unflipped = tm(_ncdhw(x))[:, 0].numpy()
    assert np.abs(unflipped - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(6, 8, 10), (7, 9, 5), (6, 7, 4)],
                         ids=["even", "odd", "mixed"])
def test_strided_unit_pads_as_flax_same(shape):
    """A stride-2 unit pads an even dimension (0, 1) and an odd one (1, 1),
    each by its own rule; where a dimension is even, symmetric padding
    gives the same shape on a grid shifted by a voxel and fails."""
    ju = junet3d._ResUnit3D(features=8, stride=2)
    x = _input(shape)
    shapes = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0),
                                            jnp.zeros(x.shape), True))
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.2, 1.0, s.shape).astype(np.float32),
        shapes["params"])
    want = np.asarray(jax.jit(lambda p, x: ju.apply({"params": p}, x, True))(
        p, jnp.asarray(x)))
    sd = state_dict_from_flax_unet3d({"_ResUnit3D_0": p})
    tu = unet3d.ResUnit3D(1, 8, stride=2)
    tu.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tu(_ncdhw(x)).numpy().transpose(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    _close(got, want, 1e-5, "unit")
    conv = tu.convs[0]
    with torch.no_grad():
        sym = F.conv3d(_ncdhw(x), conv.weight, conv.bias, 2, padding=1)
        ours = conv(_ncdhw(x))
    assert sym.shape == ours.shape
    if all(n % 2 for n in shape):
        assert torch.equal(sym, ours)
    else:
        assert float((sym - ours).abs().max()) > 1e-2


def _dice_ce_grads_jax(jm, p, x, t):
    def loss_of(params):
        lg = jnp.transpose(jm.apply({"params": params}, x, train=True),
                           (0, 4, 1, 2, 3))
        return jlosses.dice_ce_loss_3d_binary(lg, t)
    return jax.jit(jax.value_and_grad(loss_of))(p)


def _dice_ce_grads_port(tm, x, t):
    loss = losses.dice_ce_loss_3d_binary(tm(x), t)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    return loss.detach(), dict(zip([n for n, _ in tm.named_parameters()],
                                   grads))


def test_unet3d_dice_ce_gradients_match_jax():
    """The binary DiceCE loss of the remat model (JAX's default) and every
    parameter's gradient, converted back through the same map; the port's
    remat on and off give the same numbers bit for bit."""
    jm = junet3d.ResidualUNet3D(classes=1, channels=CHANNELS)
    x = _input((8, 8, 8))
    p = flax_params(jm, x.shape)
    t = (np.random.default_rng(5).random((2, 1, 8, 8, 8)) > 0.6).astype(
        np.float32)
    jloss, jgrads = _dice_ce_grads_jax(jm, p, jnp.asarray(x), jnp.asarray(t))
    want = {k: v.numpy() for k, v in state_dict_from_flax_unet3d(
        jax.tree.map(np.asarray, jgrads)).items()}
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    runs = []
    for remat in (True, False):
        tl, tg = _dice_ce_grads_port(_port(p, remat=remat), _ncdhw(x),
                                     torch.from_numpy(t))
        runs.append((tl, tg))
        _close(float(tl), float(jloss), 1e-5, "loss")
        assert tg.keys() == want.keys()
        for name, g in tg.items():
            # the flipped transpose-conv kernel's gradient flips with it
            _close(g.numpy(), want[name], 1e-4, name, floor)
    (l_on, g_on), (l_off, g_off) = runs
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(g_on[k], g_off[k]) for k in g_on)


def test_unet3d_bf16_logits_within_8_spacings():
    """``amp``: bf16 convolutions, norms and activations with f32
    parameters and f32 logits, on both sides."""
    jm = junet3d.ResidualUNet3D(classes=1, channels=CHANNELS,
                                dtype=jnp.bfloat16, fused_up=False)
    x = _input((8, 12, 8))
    p = flax_params(jm, x.shape)
    want = _apply(jm, p, x)[..., 0]
    tm = _port(p, dtype=torch.bfloat16)
    with torch.no_grad():
        got = tm(_ncdhw(x))
    assert got.dtype == torch.float32
    m = float(np.abs(want).max())
    bound = BF16_SPACINGS * 2.0 ** (np.floor(np.log2(m)) - 7)
    assert float(np.abs(got[:, 0].numpy() - want).max()) <= bound


def test_convert_unet3d_maps_every_leaf_and_raises_on_strays():
    jm = junet3d.ResidualUNet3D(classes=3, channels=(4, 8))
    p = flax_params(jm, (1, 4, 4, 4, 1))
    tm = build_unet3d(1, 3, (4, 8))
    tm.load_state_dict(state_dict_from_flax_unet3d(p))     # strict
    assert tm.units[0].acts[1].weight.shape == (1,)
    bad = dict(p)
    bad["Dense_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="Dense_0"):
        state_dict_from_flax_unet3d(bad)
    bad = {**p, "_ResUnit3D_0": {**p["_ResUnit3D_0"],
                                 "Conv_7": p["_ResUnit3D_0"]["Conv_0"]}}
    with pytest.raises(KeyError, match="Conv_7"):
        state_dict_from_flax_unet3d(bad)


def test_init_is_flax_like():
    tm = unet3d.init_weights3d(build_unet3d(1, 1, (4, 8)),
                               torch.Generator().manual_seed(0))
    assert tm.units[0].acts[0].weight.item() == pytest.approx(0.01)
    assert float(tm.units[0].norms[0].weight.detach().min()) == 1.0
    w = tm.up[0].weight                        # (Ci, Co, 2, 2, 2), fan-in Ci*8
    std = float(w.std())
    assert 0.6 * (2 / (8 * 8)) ** 0.5 < std < 1.4 * (2 / (8 * 8)) ** 0.5


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [1, 3])
def test_3d_dice_ce_losses_match_jax(rng, classes):
    """Per-sample soft Dice with smooth_nr = smooth_dr = 1e-5, no masking
    of absent classes (class 2 is absent from sample 0), plus the BCE or
    the CE, summed 1:1: values and logit gradients."""
    logits = (2 * rng.standard_normal((2, classes, 4, 6, 5))).astype(
        np.float32)
    if classes == 1:
        tgt = (rng.random((2, 1, 4, 6, 5)) > 0.5).astype(np.float32)
        jf, tf = jlosses.dice_ce_loss_3d_binary, losses.dice_ce_loss_3d_binary
    else:
        tgt = rng.integers(0, 3, (2, 4, 6, 5))
        tgt[0][tgt[0] == 2] = 1
        jf = jlosses.dice_ce_loss_3d_multiclass
        tf = losses.dice_ce_loss_3d_multiclass
    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits),
                                            jnp.asarray(tgt))
    lt = torch.from_numpy(logits).requires_grad_()
    tv = tf(lt, torch.from_numpy(tgt))
    tv.backward()
    _close(float(tv), float(jv), 1e-6, "value")
    _close(lt.grad.numpy(), np.asarray(jg), 1e-5, "grad")


# ---------------------------------------------------------------------------
# The 2-D U-Net's remat
# ---------------------------------------------------------------------------

def test_unet2d_remat_matches_plain_over_two_steps(rng):
    """``--remat``: the encoder and decoder blocks recomputed in the
    backward pass give the plain model's losses, gradients and BatchNorm
    running statistics after two steps; the recompute must not move the
    running statistics a second time (``num_batches_tracked`` counts 2)."""
    x = torch.from_numpy(rng.standard_normal((2, 1, 32, 32)).astype(
        np.float32))
    y = torch.from_numpy((rng.random((2, 32, 32)) > 0.5).astype(np.uint8))
    out = []
    for remat in (False, True):
        tm = init_weights(build_unet("unet", "resnet18", remat=remat,
                                     decoder_channels=(16, 8, 8, 8, 8)),
                          torch.Generator().manual_seed(0))
        eng = Engine(tm, losses.LossManager(),
                     make_optimizer(tm.parameters(), 1e-3, 1e-4, 5.0),
                     aug="none")
        steps = [eng.grads_one(x, y, None) for _ in range(1)]
        eng.optimizer.step(steps[0][1])
        steps.append(eng.grads_one(x, y, None))
        out.append((steps, {k: v.clone() for k, v in tm.named_buffers()}))
    (plain, pbufs), (remat, rbufs) = out
    for (lp, gp), (lr, gr) in zip(plain, remat):
        assert torch.equal(lp, lr)
        assert all(torch.equal(a, b) for a, b in zip(gp, gr))
    assert all(torch.equal(pbufs[k], rbufs[k]) for k in pbufs)
    assert int(rbufs["encoder.stem_bn.num_batches_tracked"]) == 2
