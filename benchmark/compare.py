"""The numbers that decide ``correct``, each beside its limit.

Training: each compared step's loss against the reference's
(``loss_gap``, the largest relative gap; ``loss1_gap``, the first
step's); the gradient the optimizer took at step 1 (``grad_gap``) and
the parameters' change after the compared steps (``change_gap``), both
by the worst leaf: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and
of the median leaf; ``grad_median`` and ``change_median`` take the
median leaf's gap instead. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone under Adam and
are left out of the change. Where the configuration names a ``scale``
(the reference with its GEMM operands rounded one precision below the
configuration's in the forward alone), ``*_ratio`` divide the gradient
and median-leaf change gaps by the scale's on the same seed: how far a
run is from the reference in units of how far that rounding takes it,
which takes out how sensitive one seed's weights and data make these
numbers. A cell's limits file says which numbers it compares (PERF.md
§2 gives why).

Serving: each compared answer's largest absolute gap to the reference's
over the reference's largest magnitude (``field_gap``), the worst
answer; an answer that never came reads infinity.
"""
from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> list:
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    keys = list(ref) if keys is None else list(keys)
    pn, rn = _norms({k: prog[k] for k in keys}), _norms(
        {k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def _cpu(d: dict) -> dict:
    return {k: v.detach().cpu() for k, v in d.items()}


RATIOS = ("grad_gap", "change_median")


def training(prog: dict, ref: dict, p0: dict, scale: dict = None) -> dict:
    """prog / ref / scale: {"loss": [...], "grad1": {leaf: g},
    "params": {leaf: p}} after the compared steps; p0 the starting
    parameters."""
    out = _gaps(prog, ref, p0)
    if scale is not None:
        low = _gaps(scale, ref, p0)
        out.update({f"{k}_ratio": out[k] / max(low[k], 1e-30)
                    for k in RATIOS})
    return out


def _gaps(prog: dict, ref: dict, p0: dict) -> dict:
    prog, ref = ({**d, "grad1": _cpu(d["grad1"]),
                  "params": _cpu(d["params"])} for d in (prog, ref))
    p0 = _cpu(p0)
    losses = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
              else math.inf for a, b in zip(prog["loss"], ref["loss"])]
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moved = [k for k in gn if gn[k] >= NEGLIGIBLE_GRAD * med]
    change = leaf_gaps({k: prog["params"][k] - p0[k] for k in moved},
                       {k: ref["params"][k] - p0[k] for k in moved})
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(grad), "grad_median": statistics.median(grad),
            "change_gap": max(change),
            "change_median": statistics.median(change)}


def field_gap(prog, ref) -> float:
    if prog is None:
        return math.inf
    prog = torch.as_tensor(prog, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    gap = float((prog - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)
    return gap if math.isfinite(gap) else math.inf


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is finite and within its limit. A number whose limit the cell's file
    gives as null is printed and not compared (no limit can separate its
    readings, PERF.md §2); one the file leaves out fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, "absent")
        # a JSON number, or the string "inf" where none came
        out[name] = {"value": value if math.isfinite(value) else "inf",
                     "limit": limit}
        if limit is None:
            continue
        if limit == "absent" or not (math.isfinite(value)
                                     and value <= limit):
            ok = False
    return ok, out
