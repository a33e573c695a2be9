"""The numbers that decide `correct`, each beside its limit.

Training (the first three steps of the timed call, replays of the
captured step from the seed's state):
  loss_gap.stepN   |program - reference| / |reference| of step N's loss
  grad_leaf_gap    the worst leaf's gap between the norm of step 1's
                   clipped gradient as the program's optimizer holds it
                   (its first moment over 1 - b1) and the reference's,
                   over the larger of that leaf's reference norm and the
                   median leaf's
  grad_median_gap  the median over the leaves of the same gap
  change_leaf_gap  the same for the norm of the parameters' change over
                   the three steps; leaves whose reference gradient is
                   under a thousandth of the median leaf's (which move by
                   round-off alone under Adam) are left out
  change_median_gap  the median over those leaves of the same gap
Serving (sampled requests of the window):
  frontend_gap.<family>  ||program - reference|| / ||reference|| of a
                         request's coefficient family (scattering, phase,
                         cross), the worst request
  model_gap        ||program - reference|| / ||reference|| of an output
                   of the model, the worst output and request; the
                   reference model runs on the program's coefficients

A limit lives in `limits/<workload>.json` as {"<number>": limit}.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

Check = Tuple[str, float, float]


def train_readings_of(losses: Sequence[float], grad: Sequence[float],
                      change: Sequence[float], names: Sequence[str]) -> Dict:
    return {"losses": [float(v) for v in losses],
            "grad": dict(zip(names, map(float, grad))),
            "change": dict(zip(names, map(float, change)))}


def _leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
               keep) -> Dict[str, float]:
    names = [n for n in ref if keep(n)]
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    out = {f"loss_gap.step{i + 1}": abs(p - r) / abs(r)
           for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    grad = _leaf_gaps(prog["grad"], ref["grad"], lambda n: True)
    out["grad_leaf"] = max(grad, key=grad.get)
    out["grad_leaf_gap"] = grad[out["grad_leaf"]]
    out["grad_median_gap"] = float(np.median(list(grad.values())))
    med = float(np.median(list(ref["grad"].values())))
    change = _leaf_gaps(prog["change"], ref["change"],
                        lambda n: ref["grad"][n] >= 1e-3 * med)
    out["change_leaf"] = max(change, key=change.get)
    out["change_leaf_gap"] = change[out["change_leaf"]]
    out["change_median_gap"] = float(np.median(list(change.values())))
    return out


def check_against(numbers: Mapping, limits: Mapping[str, float]) -> List[Check]:
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def of_max(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


FAMILIES = ("scattering", "phase", "cross")


def serve_numbers(pairs) -> Dict[str, float]:
    """pairs: per request (program coefficients, reference coefficients,
    program outputs, reference outputs on the program's coefficients)."""
    out = {f"frontend_gap.{f}": 0.0 for f in FAMILIES}
    out["model_gap"] = 0.0
    for pc, rc, po, ro in pairs:
        for f, a, b in zip(FAMILIES, pc, rc):
            out[f"frontend_gap.{f}"] = max(out[f"frontend_gap.{f}"],
                                           rel_l2(a, b))
        for k in ro:
            out["model_gap"] = max(out["model_gap"], rel_l2(po[k], ro[k]))
    return out


def serve_checks(pairs, limits: Mapping[str, float]) -> List[Check]:
    if not pairs:
        return [("requests_checked", 0.0, 1.0)]
    return check_against(serve_numbers(pairs), limits)


def passed(checks: Sequence[Check]) -> bool:
    """A number passes when it is at most its limit; a NaN never passes.
    `requests_checked` is the one number that has to reach its limit."""
    ok = True
    for name, value, limit in checks:
        if name == "requests_checked":
            ok &= value >= limit
        else:
            ok &= bool(value <= limit)
    return bool(ok)
