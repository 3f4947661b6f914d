"""Device -> host reads of the solve loop a step (one a loop test)."""
from port_bench.harness import solver_spans


def read(ctx):
    return solver_spans.per_solve("solver.host_syncs")
