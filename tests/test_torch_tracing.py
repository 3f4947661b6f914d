"""The solver's spans, counters and solve records (``utils/profiling.py``)
on CPU solves of two problems of the 4-node flagship:

- the counters follow the pass loop where one problem takes a second AL
  pass: passes, problems computed and advanced, one host read per loop
  test,
- the solution is bit-identical with the profiler on and off,
- under ``torch.profiler`` every span lands in the Chrome trace nested as
  the solve record says,
- with the profiler off no record is kept and ``record_function`` is never
  called.

~2.5 s of worker time (~2.5 s more where the process has not yet run
``torch.func``, which the CPU linearization uses and which loads
``torch._dynamo`` on its first call).
"""
import json
from collections import Counter

import pytest
import torch

from iterative_learning_nmpc_tpu_torch import flagship
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.utils import profiling

torch.set_num_threads(1)

IN_PASS = ("sqp.linearize", "sqp.riccati", "sqp.merit", "sqp.select")
IN_SOLVE = ("sqp.pass", "sqp.sync", "sqp.defect")


def _problem():
    """The flagship at N = 4, twice, x0 perturbed; the second problem with
    2 mm contact patches 4 mm ahead of its feet in restricted mode, so that
    its patch hinges hold it above qp_tol (0.03) for one more pass."""
    solver, X, U, p = flagship.flagship(device="cpu", n_nodes=4)
    solver.set_qp_tol(0.03)
    X, U, p = flagship.perturbed_batch(X, U, p, 2, seed=3)
    loc = tdyn.foot_positions(solver.spec, X[1, :, :18]).transpose(0, 1).clone()
    loc[:, 1:, 0] += 0.004
    p.cnt_loc[1] = loc
    p.patch_radius[1] = 0.002
    p.patch_radius[1, :, 0] = 0.01
    p.restrict[1] = 1.0
    return solver, X, U, p


def _step(solver, X, U, p):
    """One RTI step; the counters' change over it."""
    c0 = profiling.counters()
    sol = solver.solve(X, U, p, 1)
    lam = solver.update_multipliers(sol.X, sol.U, p, r_eq=sol.r_eq)
    c1 = profiling.counters()
    return sol, lam, {k: c1[k] - c0[k] for k in c1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    solver, X, U, p = _problem()
    # the same batch unrestricted: one pass each, the cheapest solve to trace
    calm = p.replace(restrict=torch.zeros_like(p.restrict))
    profiling.clear_solve_records()
    calls, real = [], torch.profiler.record_function
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function",
                   lambda *a, **k: calls.append(a) or real(*a, **k))
        varied = _step(solver, X, U, p)
        off = _step(solver, X, U, calm)
    off_records = len(profiling.solve_records())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _step(solver, X, U, calm)
    solve_id = profiling.counters()["solver.solves"]
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("sqp.")]
    return dict(solver=solver, varied=varied, off=off, on=on, calls=calls,
                off_records=off_records, records=list(profiling.solve_records()),
                solve_id=solve_id, spans=spans)


def test_counters_follow_the_pass_loop(runs):
    sol, _, d = runs["varied"]
    qp = sol.stats.qp_iters
    passes, max_qp = int(qp.max()), runs["solver"].opt.max_qp_iter
    assert qp.tolist() == [1, 2] and passes < max_qp
    assert d == {"solver.solves": 1, "solver.al_passes": passes,
                 "solver.problem_passes": 2 * passes,
                 "solver.active_problem_passes": int(qp.sum()),
                 "solver.host_syncs": 1 + passes + (passes < max_qp)}


def test_profiler_leaves_the_solution_bit_identical(runs):
    (s0, lam0, d0), (s1, lam1, d1) = runs["off"], runs["on"]
    assert s0.stats.qp_iters.tolist() == [1, 1] and d0 == d1
    assert torch.equal(lam0, lam1)
    for a, b in zip((s0.X, s0.U, s0.lam_ineq, s0.r_eq, *s0.stats),
                    (s1.X, s1.U, s1.lam_ineq, s1.r_eq, *s1.stats)):
        assert torch.equal(a, b)


def test_spans_nest_in_the_trace_as_the_record_says(runs):
    (rec,) = runs["records"]
    _, _, d = runs["on"]
    assert (rec["solve"], rec["B"], rec["N"], rec["counters"]) == (runs["solve_id"], 2, 4, d)
    assert rec["routes"] == {"linearize": "dynjac", "riccati": "pallas", "time_opt": False}
    names = [s[0] for s in rec["spans"]]
    passes = d["solver.al_passes"]
    assert names[0] == "sqp.solve" and rec["spans"][0][1] == -1
    # a freeze ends each pass and the SQP iteration (one here)
    assert Counter(names) == Counter({"sqp.solve": 1, "sqp.pass": passes,
                                      "sqp.sync": d["solver.host_syncs"],
                                      "sqp.freeze": passes + 1, "sqp.defect": 1,
                                      **{n: passes for n in IN_PASS}})
    for name, parent, t0, t1 in rec["spans"][1:]:
        pname, _, p0, p1 = rec["spans"][parent]
        if name in IN_PASS or name in IN_SOLVE:
            assert pname == ("sqp.pass" if name in IN_PASS else "sqp.solve"), name
        else:
            assert name == "sqp.freeze" and pname in ("sqp.pass", "sqp.solve")
        assert p0 <= t0 <= t1 <= p1
    assert [rec["spans"][s[1]][0] for s in rec["spans"] if s[0] == "sqp.freeze"] == (
        ["sqp.pass"] * passes + ["sqp.solve"])
    # the trace holds the same spans, each inside the one the record names
    by = {}
    for e in runs["spans"]:
        by.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert Counter({k: len(v) for k, v in by.items()}) == Counter(names) + Counter(
        {"sqp.update_multipliers": 1})
    (root,) = by["sqp.solve"]
    (upd,) = by["sqp.update_multipliers"]
    assert upd[0] >= root[1]

    def inside(c, outer):
        return any(o[0] <= c[0] and c[1] <= o[1] for o in outer)

    for name, ivals in by.items():
        outer = by["sqp.pass"] if name in IN_PASS else [root]
        if name not in ("sqp.solve", "sqp.update_multipliers"):
            assert all(inside(c, outer) for c in ivals), name


def test_no_record_and_no_record_function_with_the_profiler_off(runs):
    assert runs["off_records"] == 0
    assert runs["calls"] == []
    assert profiling.span("sqp.pass") is profiling.span("sqp.sync")
