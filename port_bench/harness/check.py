"""What decides ``correct``: the program's steps against the plain reference.

The chain is sequential, so the reference follows it step by step from the
program's own state: for each recorded step it takes the sampled problems'
inputs (X, U, lam_eq, lam_ineq) as the program had them and computes the
step again, in float64, with ``reference.rti``. The start is checked by
itself: the reference makes its own cold start from the initial states and
its own first step from there.

The inner augmented-Lagrangian loop stops a problem at the first pass whose
violation is <= qp_tol, a decision that float32 rounding can turn either
way where the violation lies near qp_tol. So the reference takes the pass
count the program reports wherever stopping there is legitimate within
``reference.rti.PASS_BAND``, and its own elsewhere. Likewise the line
search keeps the largest alpha whose merit lies within 4e-6 of the least;
where the merits lie within ``reference.rti.ALPHA_BAND`` (relative) of that
threshold and the two choices move U materially, the reference follows
both and judges the program against the nearer.

Each number is the widest, over the sampled solves, of a per-solve gap:

- ``step_u``, ``step_x``: the step's U and X, the same measure;
- ``step_lam``: the multipliers lam_eq and lam_ineq after the step;
- ``cost``: |program - reference| / |reference| of the step's merit;

and ``passes_off``, the solves whose reported pass count no rounding within
``PASS_BAND`` explains (an exact count, limit 0: a program that stops its
passes early or late shows there, where its U may still lie close).
"""
from __future__ import annotations

import torch

from ..reference import inputs as ref_inputs
from ..reference.rti import RTI


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per solve (leading dim): max |a - ref| / (1 + max |ref|)."""
    a, ref = a.to(ref.dtype), ref
    d = (a - ref).abs().flatten(1).amax(1)
    d = torch.where(torch.isfinite(a).flatten(1).all(1), d, torch.full_like(d, float("inf")))
    return d / (1.0 + ref.abs().flatten(1).amax(1))


def gaps(prog: dict, ref: dict) -> dict:
    """Per-solve gaps of one batch of recorded steps."""
    lam = lambda d: torch.cat([d["lam_eq"].flatten(1), d["lam_ineq"].flatten(1)], 1)
    c_p, c_r = prog["cost"].to(ref["cost"].dtype), ref["cost"]
    cost = (c_p - c_r).abs() / c_r.abs().clamp_min(1e-30)
    cost = torch.where(torch.isfinite(c_p), cost, torch.full_like(cost, float("inf")))
    return dict(step_u=rel_gap(prog["U"], ref["U"]), step_x=rel_gap(prog["X"], ref["X"]),
                step_lam=rel_gap(lam(prog), lam(ref)), cost=cost)


def compare(cell, robot, nom, records: dict, device) -> dict:
    """Run the reference over the recorded steps and return each compared
    number (a solve whose reported pass count is off is judged against the
    reference's own count); beside them, not compared, ``start`` (the cold
    start's gap, |program - reference| / (1 + max |reference|) over X and
    U), and ``pass_need`` and ``alpha_need``, the widest band that a
    solve's reported pass count and its line-search choices needed
    (``reference.rti.RTI.step``)."""
    rti = RTI(robot, cell.opt, cell.config, torch.float64, device)
    to = lambda t: t.to(device=device, dtype=torch.float64)
    # the start: the reference's own cold start and first step
    first = records["first"]
    p = ref_inputs.batch_params(nom, to(first["x0"]), rti.h)
    X0, U0 = ref_inputs.cold_start(robot, p)
    out = dict(start=torch.maximum(rel_gap(to(first["in"]["X"]), X0),
                                   rel_gap(to(first["in"]["U"]), U0)).max().item())
    per = []
    r = rti.step(X0, U0, p["lam_eq"], p["lam_ineq"], p, reported=first["out"]["qp_iters"],
                 judge=first["out"]["U"])
    per.append((gaps(first["out"], r), r, first["out"]["qp_iters"]))
    steps = records["steps"]
    if steps:
        cat = lambda part, k: torch.cat([s[part][k] for s in steps])
        x0 = torch.cat([first["x0"]] * len(steps))
        p = ref_inputs.batch_params(nom, to(x0), rti.h)
        prog = {k: cat("out", k) for k in steps[0]["out"]}
        r = rti.step(to(cat("in", "X")), to(cat("in", "U")), to(cat("in", "lam_eq")),
                     to(cat("in", "lam_ineq")), p, reported=prog["qp_iters"],
                     judge=prog["U"])
        per.append((gaps(prog, r), r, prog["qp_iters"]))
    for k in per[0][0]:
        out[k] = max(g[k].max().item() for g, _, _ in per)
    # solves whose reported pass count is not one a rounding could give
    out["passes_off"] = int(sum(int((rep.to(device) != r["qp_iters"]).sum()) for _, r, rep in per))
    for k in ("pass_need", "alpha_need"):
        out[k] = max(r[k].max().item() for _, r, _ in per)
    out["solves_compared"] = int(sum(g["cost"].numel() for g, _, _ in per))
    return out
