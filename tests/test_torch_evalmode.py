"""Eval-mode quality after a short training, JAX engine against the port's.

A checkpoint taken after a few steps from a fresh init segments badly in
eval mode: BatchNorm's running statistics have moved only ``1 - 0.9^N`` of
the way from their init (mean 0, var 1) towards the batches' statistics,
so eval mode normalizes with statistics the network never trained with.
This test takes the same 10 steps with both engines from the same
parameters and identity statistics, on the same batches, then compares
eval mode: the masks, Dice and IoU of ``validate``, and the logits.

The small model of ``tests/test_torch_train.py`` (ResNet18 encoder,
decoder (32, 16, 16, 8, 8), 64x64, batch 4), f32, JAX's plain decoder
(equal in f32 to its fused one, and quicker to compile). Tolerances: val Dice
and IoU within 2e-3, at least 99 % of eval-mode mask pixels equal, the
share of positive pixels within 0.5 %, the logits within 10 % of the
largest |logit| (each Adam step moves an element by about lr whatever its
gradient's size, so an ulp of gradient rounding that flips a sign moves
weights by lr; ``tests/test_torch_train.py`` bounds the parameters after
three steps the same way).
"""
import jax
import numpy as np
import torch

from test_torch_model import NARROW, jax_variables
from test_torch_train import (BATCH, HW, _engines, _jax_steps, _stores,
                              jax_build)

STEPS = 10


def test_eval_mode_after_ten_steps_matches_jax():
    jm = jax_build("unet", "resnet18", "none", decoder_channels=NARROW,
                   fused_decoder=False)
    v = jax_variables(jm, HW)
    identity = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.ones_like(a) if p[-1].key == "var"
                      else np.zeros_like(a)), v["batch_stats"])
    small = (jm, {"params": v["params"], "batch_stats": identity})
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(12)[:BATCH]
                     for _ in range(STEPS)]).astype(np.int32)
    jeng, state, eng = _engines(small)
    new, _ = _jax_steps(jeng, state, perm)
    jstore, store = _stores(12)
    eng.train_steps(store, torch.from_numpy(perm).long(), None)

    _, jdice, jiou = jeng.validate(new, jstore, BATCH)
    _, dice, iou = eng.validate(store, BATCH)
    assert abs(dice - jdice) <= 2e-3 and abs(iou - jiou) <= 2e-3
    jlog = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": new.params, "batch_stats": new.batch_stats},
        jstore.images[:, :, :, None]))[..., 0]
    eng.model.eval()
    with torch.no_grad():
        log = eng.model(store.images[:, None].float())[:, 0].numpy()
    assert np.abs(log - jlog).max() <= 0.1 * np.abs(jlog).max()
    assert ((log > 0) == (jlog > 0)).mean() >= 0.99
    assert abs((log > 0).mean() - (jlog > 0).mean()) <= 0.005
    # both engines' eval masks are degenerate after 10 steps: nearly every
    # pixel positive, where the target holds about half
    target = float((store.masks > 0).float().mean())
    assert (jlog > 0).mean() > 0.9 and 0.3 < target < 0.7
