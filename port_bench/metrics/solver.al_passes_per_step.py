"""Inner AL passes a step: the traced solves' ``solver.al_passes`` over
their number (the solver's own count; every route, kernel 2 or not)."""
from port_bench.harness import solver_spans


def read(ctx):
    return solver_spans.per_solve("solver.al_passes")
