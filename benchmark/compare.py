"""The numbers that decide ``correct``: each a gap between what the
measured side produced and what the reference computes, held against the
cell's limit (``limits/<workload>.json``).

Training (the checked first steps):

* ``loss_rel`` — the largest |measured - reference| / |reference| over the
  steps' three losses (verb, nouns, gt nouns);
* ``grad_rel`` — over the leaves, the largest gap between the first
  step's clipped gradient norms, |‖g‖ - ‖g_ref‖|, over the larger of the
  leaf's reference norm and the median leaf's;
* ``change_rel`` — the same for the norm of each leaf's change over the
  steps, leaving out the elements whose reference gradient is under a
  thousandth of the median leaf's root mean square (they move under
  Adamax by round-off alone, as a key's bias does under softmax, a third
  of the packed q/k/v bias);
* ``verb_gap`` — in the first step, where both sides start from the same
  weights, the largest amount by which the reference's logit of the
  measured side's argmax verb lies below the reference's best;
* ``gt_noun_gap`` — the same of the gt-verb branch (the forward-only
  propagate, K1 on the card) in the first step: over the rows and each
  verb's real roles, the most the reference's logit of the measured
  side's first noun lies below the reference's best.

Both gaps are read in the first step alone: Adamax's first update moves
every element by the rate in its gradient's sign, so where rounding
flips a sign the two sides part, and the later steps' gaps read nearly
as much for the sound program as for the control (they are kept for the
record, ``_at``).  The later steps pick by the same code as the first;
a pick that the program trains but reports otherwise makes the
reference train other rows, which ``change_rel`` reads.
"""

from __future__ import annotations

import statistics

#: an element whose reference gradient is under this share of the median
#: leaf's RMS moves by round-off alone and is left out of ``change_rel``
STILL = 1e-3


def _norm_gap(got: dict, ref: dict) -> tuple:
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for n in ref:
        gap = abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def changes(got: dict, ref: dict) -> tuple:
    """Each leaf's norm of change on both sides over the elements that
    move ({leaf: norm}, {leaf: norm}), and how many elements stood still."""
    rms = {n: float(g.float().pow(2).mean().sqrt())
           for n, g in ref["grad_t"].items()}
    floor = STILL * statistics.median(rms.values())
    out_got, out_ref, still = {}, {}, 0
    for n, g in ref["grad_t"].items():
        keep = (g.abs() >= floor).cpu()
        still += int(keep.numel() - keep.sum())
        if keep.any():
            out_got[n] = float(got["delta_t"][n].float().cpu()[keep].norm())
            out_ref[n] = float(ref["delta_t"][n].float().cpu()[keep].norm())
    return out_got, out_ref, still


def training(got: dict, ref: dict) -> dict:
    """The training numbers of ``got`` (the measured side: ``losses``,
    ``grad`` norms, ``delta_t`` changes) against ``ref``
    (``reference.train.steps`` following ``got``'s verb and gt-noun
    choices: ``verb_gap`` and ``gt_noun_gap`` are its own)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for ga, ra in zip(got["losses"], ref["losses"])
               for a, b in zip(ga, ra))
    grad, grad_at = _norm_gap(got["grad"], ref["grad"])
    cg, cr, still = changes(got, ref)
    change, change_at = _norm_gap(cg, cr)
    return {"loss_rel": loss, "grad_rel": grad, "change_rel": change,
            "verb_gap": ref["verb_gap"][0],
            "gt_noun_gap": ref["gt_noun_gap"][0],
            "_at": {"grad_rel": grad_at, "change_rel": change_at,
                    "still_elements": still,
                    "verb_gaps": ref["verb_gap"],
                    "gt_noun_gaps": ref["gt_noun_gap"]}}


def checks(readings: dict, lim: dict) -> tuple:
    """(whether every number is within its limit, {name: {value, limit}})
    in the limits file's order."""
    out = {n: {"value": readings[n], "limit": lim[n]} for n in lim
           if not n.startswith("_")}
    ok = all(c["value"] <= c["limit"] for c in out.values())
    return ok, out
