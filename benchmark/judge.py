"""The comparison that decides ``correct``.

The program's first three steps (through the window's own step and feed)
against the plain reference's three steps from the same weights, batches,
negatives and dropout stream:

- ``loss_gap``: the largest ``|loss - reference| / |reference|`` over the
  three steps;
- ``grad_gap``: the first step's gradient as the optimizer takes it (the
  program's, worked out from its first moment after one step, ``mu / (1 -
  b1)``), leaf by leaf: the gap between the program's norm and the
  reference's over the larger of the reference's norm of that leaf and of
  the median leaf; the worst leaf;
- ``grad_gap_but_rel_bias`` and ``rel_bias_gap``: the worst leaf by the
  same rule among every leaf but the relation biases, and among the
  relation biases alone. A configuration in bf16 holds the two apart:
  a relation bias's gradient sums the cotangent over every feature and
  in-edge with heavy cancellation, so one bf16 rounding flipped
  downstream moves it by percents, far more than any other leaf. Where
  that sum cancels past any limit (a hub's in-edges over every feature),
  a cell compares the relation biases by their change alone;
- ``change_gap``: the same of each parameter's change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off).

A cell's limits file names the numbers it compares.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_but_rel_bias", "rel_bias_gap",
           "change_gap")
REL_BIAS = ".rel_bias"
NEGLIGIBLE_GRAD = 1e-3


def _finite_or_inf(x: float) -> float:
    """A gap that is NaN reads as infinitely far off (``max`` would drop
    it)."""
    return x if x == x else float("inf")


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or k in keep]
    a, b = _norms({k: prog[k] for k in names}), _norms(
        {k: ref[k] for k in names})
    med = statistics.median(b.values())
    return {k: _finite_or_inf(abs(a[k] - b[k]) / max(b[k], med)
                              if max(b[k], med) > 0 else abs(a[k] - b[k]))
            for k in names}


def readings(prog: dict, ref: dict) -> dict:
    """The numbers (and the worst leaves) of a program record
    ``{losses, first_grad, start, params}`` against the reference's
    ``run_steps`` result."""
    losses: List[float] = prog["losses"]
    loss_gap = max(_finite_or_inf(abs(a - b) / abs(b))
                   for a, b in zip(losses, ref["losses"]))
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"])
    grad_leaf = max(grads, key=grads.get)
    biases = [grads[k] for k in grads if k.endswith(REL_BIAS)]
    others = [grads[k] for k in grads if not k.endswith(REL_BIAS)]
    med = statistics.median(ref["raw_grad_norms"].values())
    moving = {k for k, v in ref["raw_grad_norms"].items()
              if v >= NEGLIGIBLE_GRAD * med}
    change = {k: prog["params"][k].float() - prog["start"][k].float()
              for k in prog["params"]}
    ref_change = {k: ref["params"][k] - ref["start"][k] for k in ref["params"]}
    changes = leaf_gaps(change, ref_change, keep=moving)
    change_leaf = max(changes, key=changes.get)
    return {"loss_gap": loss_gap, "grad_gap": grads[grad_leaf],
            "grad_gap_but_rel_bias": max(others),
            "rel_bias_gap": max(biases, default=0.0),
            "change_gap": changes[change_leaf], "grad_leaf": grad_leaf,
            "change_leaf": change_leaf, "grad_leaves": grads,
            "left_out": sorted(set(ref["params"]) - moving)}


def judge(numbers: dict, finite: List[bool], limits: dict) -> Tuple[bool, dict]:
    """``(correct, checks)``: each number the cell's ``limits`` name at or
    under its limit, and every checked step finite."""
    compared = [k for k in NUMBERS if k in limits]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in compared}
    checks["finite_steps"] = {"value": sum(bool(f) for f in finite),
                              "limit": len(finite)}
    ok = all(numbers[k] <= limits[k] for k in compared) and all(finite)
    return ok, checks
