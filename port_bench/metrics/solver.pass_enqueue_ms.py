"""Mean host time of an AL pass (``sqp.pass``), in ms: the pass holds no
sync, so this is the host's time to enqueue it, to set beside the device's
busy time a pass."""
import statistics

from port_bench.harness import solver_spans


def read(ctx):
    ms = solver_spans.span_ms(solver_spans.records(), "sqp.pass")
    return statistics.fmean(ms) if ms else None
