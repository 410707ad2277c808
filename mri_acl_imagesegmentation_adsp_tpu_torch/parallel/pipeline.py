"""GPipe pipeline parallelism over ranks, and VarNet's cascades as its
stages.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/parallel/pipeline.py``:
``gpipe`` (:50-120), ``stack_cascade_params`` (:127-131) and
``varnet_apply_pipelined`` (:134-193). There, stacked stage parameters are
sharded over a "pipe" mesh axis and one ``lax.scan`` in ``shard_map``
circulates the activations by ``ppermute``; reverse-mode AD derives the
backward pipeline. Here one process drives one device (a rank of a pipe
group, ``parallel/mesh.py``), every rank holds the whole model and runs
only its stages:

- rank ``s`` of ``S`` owns the ``s``-th consecutive group of ``len(stages)
  / S`` stages and walks the GPipe schedule, ``M + S - 1`` steps for ``M``
  microbatches, running microbatch ``t - s`` at step ``t``; an idle step
  runs nothing (JAX computes on a finite stand-in and masks it out);
- an activation goes from rank ``s`` to ``s + 1`` through
  :class:`_PipeSend` / :class:`_PipeRecv`, autograd functions whose
  backward sends the gradient from ``s + 1`` back to ``s``; a send does
  not wait for its receiver (``mesh.isend``), a receive blocks, so no rank
  waits on one that waits on it, whatever order the backward pass takes;
  each microbatch's message has its own tag;
- per-microbatch constants (VarNet's reference k-space and sensitivity
  maps) are indexed locally on every rank, never sent;
- the last rank's outputs reach every rank through one differentiable sum
  (``all_reduce_sum``, JAX's ``psum``), the other ranks adding zeros.

The gradient rule. Every rank computes the same loss from the summed
outputs, and the sum's backward sums the upstream gradient over the pipe
ranks: the gradient each rank takes is that of the sum of the ``S`` ranks'
losses with respect to its own copy of the weights (a stage's only on its
owner, the sensitivity model's through the stages it feeds on each rank
and through the final combine on every rank). Summed over the ranks that
is ``S`` times the loss's gradient, so the rule is the MEAN over the pipe
ranks (``mesh.average_flat``), after which every rank holds the full
gradient and takes the same step. A sum would step ``S`` times too far.

Gradients must be taken with respect to every stage's parameters (a
rank's first stage parameter anchors its receives in the graph, so that
their backward, which sends, runs).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import DataGroup, all_reduce_sum, isend, recv, wait_sends


class _PipeSend(torch.autograd.Function):
    """Send the state to ``peer`` (not waiting); returns zeros of its
    shapes (this rank's share of the final sum). The backward receives the
    state's gradient from ``peer``."""

    @staticmethod
    def forward(ctx, group, peer, tag, *xs):
        ctx.meta = (group, peer, tag,
                    [(x.shape, x.dtype, x.device) for x in xs])
        for i, x in enumerate(xs):
            isend(x, peer, group, tag + i)
        return tuple(torch.zeros_like(x) for x in xs)

    @staticmethod
    def backward(ctx, *_):
        group, peer, tag, likes = ctx.meta
        grads = [recv(torch.empty(s, dtype=d, device=dev), peer, group,
                      tag + i) for i, (s, d, dev) in enumerate(likes)]
        return (None, None, None, *grads)


class _PipeRecv(torch.autograd.Function):
    """Receive the state from ``peer``, shaped as ``likes``; the backward
    sends its gradient back (``anchor`` only ties the op into the graph,
    and takes no gradient)."""

    @staticmethod
    def forward(ctx, anchor, group, peer, tag, likes):
        ctx.meta = (group, peer, tag)
        return tuple(recv(like, peer, group, tag + i)
                     for i, like in enumerate(likes))

    @staticmethod
    def backward(ctx, *grads):
        group, peer, tag = ctx.meta
        for i, g in enumerate(grads):
            isend(g, peer, group, tag + i)
        return None, None, None, None, None


def _anchor(stage) -> torch.Tensor:
    if isinstance(stage, torch.Tensor):
        return stage
    return next(stage.parameters())


def gpipe(group: Optional[DataGroup], stage_fn: Callable,
          stages: Sequence, micro_state: Tuple[torch.Tensor, ...],
          micro_consts: Tuple[torch.Tensor, ...]
          ) -> Tuple[torch.Tensor, ...]:
    """Run the ``S`` stages over ``M`` microbatches, pipelined over
    ``group``'s ranks (in order on one rank without a group).

    ``stage_fn(stage, state, consts) -> state`` with ``state`` and
    ``consts`` tuples of one microbatch's tensors; ``stages`` the
    ``S_total`` stages in order (modules or tensors), a multiple of the
    group's size; ``micro_state`` / ``micro_consts`` tuples of ``(M, mb,
    ...)`` tensors, the circulating state and the per-microbatch
    constants, the same on every rank. Returns the final state, ``(M, mb,
    ...)`` tensors, on every rank (module docstring)."""
    size = group.world if group is not None else 1
    if not stages:
        raise ValueError("no stages")
    if len(stages) % size:
        raise ValueError(f"{len(stages)} stages do not tile a {size}-way "
                         "pipe axis")
    n_micro = int(micro_state[0].shape[0])
    s = group.rank if group is not None else 0
    per = len(stages) // size
    mine = list(stages)[s * per:(s + 1) * per]
    wait_sends()        # the sends of the last call's backward pass
    outs: List[Tuple[torch.Tensor, ...]] = []
    n_leaves = len(micro_state)
    for t in range(n_micro + size - 1):
        m = t - s
        if not 0 <= m < n_micro:
            continue                    # an idle step of the schedule
        tag = m * n_leaves
        if s == 0:
            x = tuple(a[m] for a in micro_state)
        else:
            x = _PipeRecv.apply(_anchor(mine[0]), group, s - 1, tag,
                                [a[m] for a in micro_state])
        consts = tuple(a[m] for a in micro_consts)
        for stage in mine:
            x = tuple(stage_fn(stage, x, consts))
        if s + 1 < size:
            x = _PipeSend.apply(group, s + 1, tag, *x)
        outs.append(x)
    wait_sends()
    stacked = [torch.stack([o[i] for o in outs]) for i in range(n_leaves)]
    if group is None:
        return tuple(stacked)
    # one non-zero addend an element: exact in any dtype at least f32
    acc = torch.promote_types(stacked[0].dtype, torch.float32)
    flat = all_reduce_sum(torch.cat([a.reshape(-1).to(acc)
                                     for a in stacked]), group)
    out, at = [], 0
    for a in stacked:
        out.append(flat[at:at + a.numel()].view(a.shape).to(a.dtype))
        at += a.numel()
    return tuple(out)


# ---------------------------------------------------------------------------
# VarNet: cascades as pipeline stages
# ---------------------------------------------------------------------------

def stack_cascade_params(state_dict: Dict[str, torch.Tensor],
                         num_cascades: int) -> Dict[str, torch.Tensor]:
    """The cascades' parameters of a ``VarNet`` state_dict stacked on a
    leading dim, by their name inside a cascade (JAX's stacked subtrees;
    the model itself keeps its own layout)."""
    names = [k[len("cascades.0."):] for k in state_dict
             if k.startswith("cascades.0.")]
    return {n: torch.stack([state_dict[f"cascades.{i}.{n}"]
                            for i in range(num_cascades)]) for n in names}


def varnet_apply_pipelined(model, kspace: torch.Tensor,
                           espirit: torch.Tensor,
                           group: Optional[DataGroup],
                           n_microbatches: Optional[int] = None
                           ) -> torch.Tensor:
    """``model(kspace, espirit)`` of a ``recon/varnet.py:VarNet`` (no coil
    grid) with its cascades pipelined over ``group``'s ranks: the
    sensitivity model and the final coil combine run on every rank, the
    ``num_cascades`` ``VarNetBlock``s as GPipe stages over
    ``n_microbatches`` microbatches (default: the group's size), which
    must divide the batch. Returns ``|image|`` ``(b, aves, h, w)`` on
    every rank."""
    from ..recon.varnet import acc_dtype, sens_reduce_parts

    if model.mesh is not None:
        raise ValueError("a pipelined VarNet takes no (data, coil) grid")
    b = int(kspace.shape[0])
    m = n_microbatches or (group.world if group is not None else 1)
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    dt, acc = model.dtype, acc_dtype(model.dtype)
    e32 = espirit.to(acc)
    sr, si = model.sens_net(e32[..., 0], e32[..., 1], None)
    kr = kspace[..., 0].to(dt).contiguous()
    ki = kspace[..., 1].to(dt).contiguous()
    sr, si = sr.to(dt), si.to(dt)

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(m, b // m, *x.shape[1:])

    def stage_fn(block, state, consts):
        return block(*state, *consts, None)

    out_r, out_i = gpipe(group, stage_fn, list(model.cascades),
                         (split(kr), split(ki)),
                         (split(kr), split(ki), split(sr), split(si)))
    fr = out_r.reshape(b, *out_r.shape[2:])
    fi = out_i.reshape(b, *out_i.shape[2:])
    rr, ri = sens_reduce_parts(fr, fi, sr, si, None)
    rr, ri = rr.to(acc), ri.to(acc)
    return torch.sqrt(rr * rr + ri * ri)


def pipeline_grads(loss: torch.Tensor, params: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """The gradients of ``loss`` for every parameter, zeros for those of
    the stages another rank runs."""
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]
