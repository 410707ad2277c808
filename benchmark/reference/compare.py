"""The numbers that decide ``correct``: each a reading of the program's
output against the reference's, held to a limit of its own
(``limits/<cell>.json``)."""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam and is left out of the change
FLAT_GRAD_SHARE = 1e-3


def _leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
               keep: torch.Tensor | None = None) -> torch.Tensor:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's and the median leaf's reference
    norm."""
    prog, ref = prog.double(), ref.double()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return (prog - ref).abs() / torch.maximum(ref, ref.median())


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the worst step's loss gap relative to the reference's
    loss (``loss_gap_first``: the first step's); ``grad_gap``: the first
    clipped gradient, worst leaf (``grad_gap_median``: the median leaf);
    ``update_gap``: the parameters' change over the steps, worst leaf
    (``update_gap_median``: the median leaf), without the leaves whose
    reference gradient is all but zero; ``bn_var_gap_median``: the first
    step's batch variance of every BatchNorm channel, its gap relative to
    the reference's, the median over channels."""
    lp = torch.tensor(prog["losses"], dtype=torch.float64)
    lr = torch.tensor(ref["losses"], dtype=torch.float64)
    loss = (lp - lr).abs() / lr.abs()
    g = ref["grad_norms"].double()
    keep = g >= FLAT_GRAD_SHARE * g.median()
    grad = _leaf_gaps(prog["grad_norms"], g)
    upd = _leaf_gaps(prog["delta_norms"], ref["delta_norms"], keep)
    bn = ((prog["bn_vars"].double() - ref["bn_vars"].double()).abs()
          / ref["bn_vars"].double().clamp_min(1e-30))
    return {"loss_gap": float(loss.max()), "loss_gap_first": float(loss[0]),
            "bn_var_gap_median": float(bn.median()),
            "grad_gap": float(grad.max()),
            "grad_gap_median": float(grad.median()),
            "update_gap": float(upd.max()),
            "update_gap_median": float(upd.median())}


def answer_readings(answers: Iterable[dict], refs: Sequence[dict]
                    ) -> Dict[str, float]:
    """Each served answer against the reference of its volume.

    ``body_mask_share``: the largest share of an answer's body-mask pixels
    that differ from the reference's; ``mask_logit_gap``: the widest gap by
    which a returned mask pixel lies on the wrong side of the reference's
    threshold (logit 0), in units of the RMS of that volume's reference
    logits; ``mask_flip_share``: the largest share of an answer's mask
    pixels on the wrong side. A malformed answer (shapes, slice indices)
    reads infinity."""
    body, gap, flips = 0.0, 0.0, 0.0
    for a in answers:
        r = refs[a["volume"]]
        logits, rmask = r["logits"], r["body_mask"]
        s = logits.shape[0]
        mask = torch.as_tensor(a["mask"])
        bmask = torch.as_tensor(a["body_mask"])
        idx = torch.as_tensor(a["indices"])
        if (tuple(mask.shape) != tuple(logits.shape)
                or tuple(bmask.shape) != tuple(rmask.shape)
                or mask.dtype != torch.uint8 or bmask.dtype != torch.uint8
                or not torch.equal(idx, torch.arange(s))):
            return {"body_mask_share": float("inf"),
                    "mask_logit_gap": float("inf"),
                    "mask_flip_share": float("inf")}
        body = max(body, float((bmask.bool() != rmask).double().mean()))
        wrong = mask.bool() != (logits > 0)
        flips = max(flips, float(wrong.double().mean()))
        if bool(wrong.any()):
            rms = float(logits.double().square().mean().sqrt())
            gap = max(gap, float(logits[wrong].abs().max()) / rms)
    return {"body_mask_share": body, "mask_logit_gap": gap,
            "mask_flip_share": flips}


def held(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading at or under its limit (a NaN fails)."""
    return all(readings[k] <= limits[k] for k in limits)
