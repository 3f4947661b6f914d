"""The problems the AL passes advanced over the problems they computed
(B a pass: a problem that has stopped is computed and frozen), in %."""
from port_bench.harness import solver_spans


def read(ctx):
    recs = solver_spans.records()
    computed = solver_spans.counter_total(recs, "solver.problem_passes")
    if not computed:
        return None
    return 100.0 * solver_spans.counter_total(recs, "solver.active_problem_passes") / computed
