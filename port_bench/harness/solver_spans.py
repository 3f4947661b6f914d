"""The port's solve records (``utils/profiling.solve_records``): the spans
and counter deltas of each ``TrajOptSolver.solve`` made while the profiler
ran. The harness runs the profiler over the traced steps (``trace.Tracer``)
and ``warm_profiler``'s one op only, so the records are the traced steps'
solves, one a step. A program that keeps no records, or a step that is not
the port's solve (``port_bench/control.py``), leaves none, and every reader
of them gives None.

The port is imported inside the function only, as in ``program.py``.
"""
from __future__ import annotations


def records() -> list:
    """The solve records, oldest first; [] where the program keeps none."""
    try:
        from iterative_learning_nmpc_tpu_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "solve_records", None)
    return list(get()) if get is not None else []


def counter_total(recs: list, name: str) -> int:
    return sum(r["counters"][name] for r in recs)


def span_ms(recs: list, name: str) -> list:
    """The host duration (ms) of every span named ``name``."""
    return [(t1 - t0) * 1e-6 for r in recs for n, _, t0, t1 in r["spans"] if n == name]


def per_solve(name: str):
    """A counter's total over the recorded solves, a solve; None without
    records."""
    recs = records()
    return counter_total(recs, name) / len(recs) if recs else None
