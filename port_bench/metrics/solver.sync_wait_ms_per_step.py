"""Host time in the solve loop's syncs (``sqp.sync``) a step, in ms: the
host waiting on the card."""
from port_bench.harness import solver_spans


def read(ctx):
    recs = solver_spans.records()
    if not recs:
        return None
    return sum(solver_spans.span_ms(recs, "sqp.sync")) / len(recs)
