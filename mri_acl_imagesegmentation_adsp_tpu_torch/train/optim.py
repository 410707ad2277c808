"""AdamW after a global-norm clip, and RMSprop, as the JAX package's optax
chains compute them.

Counterpart: ``make_optimizer`` in
``mri_acl_imagesegmentation_adsp_tpu/train/engine.py:50-77``:
``optax.chain(optax.clip_by_global_norm(max_grad_norm),
optax.adamw(lr, weight_decay=weight_decay))`` with an injectable learning
rate. Per step, for the gradients ``g`` of every parameter ``p``:

* clip: ``n = sqrt(sum(g^2))`` over all gradients; when ``n >= max_norm``
  each ``g`` becomes ``g / n * max_norm`` (optax adds no epsilon to ``n``,
  unlike ``torch.nn.utils.clip_grad_norm_``);
* Adam: ``m = 0.9 m + 0.1 g``, ``v = 0.999 v + 0.001 g^2``, ``u = m_hat /
  (sqrt(v_hat) + 1e-8)`` with the bias corrections ``1 - b^t``;
* decoupled decay on every parameter, BatchNorm's and the biases included
  (optax masks none): ``p -= lr * (u + weight_decay * p)``.

VarNet trains with ``optax.adamw(lr, weight_decay)`` and no clip
(``train/varnet_trainer.py:138-141`` there): ``ClippedAdamW`` with
``max_grad_norm=0``. The recon U-Net trains with ``optax.rmsprop(lr,
decay=0.99, eps=1e-8)`` (``train/unet_recon_trainer.py:83-87``), which is
:class:`RMSprop` here: ``nu = decay nu + (1 - decay) g^2`` from zeros, then
``p -= lr * g * rsqrt(nu + eps)``. optax 0.2.6 puts ``eps`` inside the root
(``eps_in_sqrt=True``); ``torch.optim.RMSprop`` adds it outside, ``g /
(sqrt(v) + eps)``, which is another optimizer while ``v`` is small.

The classifier trains with optax's own optimizers
(``classify/trainer.py:137-149`` there): ``adam`` is ``optax.adamw``
(``ClippedAdamW`` with ``max_grad_norm=0``); ``adam`` with ``amsgrad`` is
the chain ``scale_by_amsgrad``, ``add_decayed_weights``,
``scale_by_learning_rate`` (``ClippedAdamW(amsgrad=True)``): the update
divides by the running maximum of the *bias-corrected* ``nu``, where
``torch.optim.AdamW(amsgrad=True)`` keeps the maximum of the raw ``nu``
(another optimizer), and the decay again reaches every parameter; ``sgd``
is ``optax.sgd(lr, momentum)``, :class:`SGDMomentum`: ``trace = g +
momentum * trace`` from zeros (no dampening, no decay), ``p -= lr *
trace``.

Each step runs as multi-tensor (``torch._foreach_*``) operations on the
parameters' device and reads nothing back to the host.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch


class ClippedAdamW:
    """The optimizer; ``lr`` may be set between steps, and ``count`` is the
    number of steps taken (optax's ``ScaleByAdamState.count``). With
    ``amsgrad`` the update divides by ``nu_max``, the running maximum of
    the bias-corrected second moment (optax's ``scale_by_amsgrad``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float, max_grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 amsgrad: bool = False):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p, memory_format=torch.preserve_format)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format)
                   for p in self.params]
        self.nu_max = ([torch.zeros_like(p) for p in self.params]
                       if amsgrad else None)
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads``, aligned with ``params``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        g = list(grads)
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            scale = torch.where(norm < self.max_grad_norm,
                                torch.ones_like(norm),
                                self.max_grad_norm / norm)
            g = torch._foreach_mul(g, scale)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        # the bias corrections in f32, as optax computes 1 - b**count
        bc1 = float(1 - torch.tensor(b1) ** self.count)
        bc2 = float(1 - torch.tensor(b2) ** self.count)
        den = torch._foreach_div(self.nu, bc2)
        if self.nu_max is not None:
            torch._foreach_maximum_(self.nu_max, den)
            den = torch._foreach_sqrt(self.nu_max)
        else:
            torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, self.lr)
        torch._foreach_sub_(self.params, upd)

    def state_dict(self) -> dict:
        """The moments and the step count (optax's ``ScaleByAdamState``;
        with ``amsgrad`` also ``nu_max``); the learning rate is the
        schedule's, set each epoch."""
        out = {"mu": list(self.mu), "nu": list(self.nu),
               "count": int(self.count)}
        if self.nu_max is not None:
            out["nu_max"] = list(self.nu_max)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in, onto the parameters' devices."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(
                self.nu):
            raise ValueError(f"optimizer state for {len(state['mu'])} "
                             f"parameters, not {len(self.mu)}")
        if (self.nu_max is None) != ("nu_max" not in state):
            raise ValueError("optimizer state with and without amsgrad's "
                             "nu_max do not mix")
        for dst, src in zip(self.mu + self.nu + (self.nu_max or []),
                            state["mu"] + state["nu"]
                            + state.get("nu_max", [])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment of shape "
                                 f"{tuple(src.shape)}, not "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float, max_grad_norm: float) -> ClippedAdamW:
    """AdamW(lr, weight_decay) after a clip at ``max_grad_norm`` (none when
    it is 0)."""
    return ClippedAdamW(params, lr, weight_decay, max_grad_norm)


class RMSprop:
    """optax's ``rmsprop(lr, decay, eps)`` (not centred, no momentum);
    ``lr`` may be set between steps."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 decay: float = 0.99, eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.decay, self.eps = float(lr), float(decay), float(eps)
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format)
                   for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads``, aligned with ``params``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        g = list(grads)
        torch._foreach_mul_(self.nu, self.decay)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.decay)
        scale = torch._foreach_add(self.nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, g)
        torch._foreach_mul_(scale, self.lr)
        torch._foreach_sub_(self.params, scale)

    def state_dict(self) -> dict:
        """optax's ``ScaleByRmsState``: the second moments."""
        return {"nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["nu"]) != len(self.nu):
            raise ValueError(f"optimizer state for {len(state['nu'])} "
                             f"parameters, not {len(self.nu)}")
        for dst, src in zip(self.nu, state["nu"]):
            dst.copy_(src)


class SGDMomentum:
    """optax's ``sgd(lr, momentum)``: ``trace = g + momentum * trace``
    from zeros, ``p -= lr * trace``; ``lr`` may be set between steps."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 momentum: float = 0.9):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.momentum = float(lr), float(momentum)
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads``, aligned with ``params``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, list(grads))
        torch._foreach_sub_(self.params, torch._foreach_mul(self.trace,
                                                            self.lr))

    def state_dict(self) -> dict:
        """optax's ``TraceState``: the momentum buffers."""
        return {"trace": list(self.trace)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["trace"]) != len(self.trace):
            raise ValueError(f"optimizer state for {len(state['trace'])} "
                             f"parameters, not {len(self.trace)}")
        for dst, src in zip(self.trace, state["trace"]):
            dst.copy_(src)
