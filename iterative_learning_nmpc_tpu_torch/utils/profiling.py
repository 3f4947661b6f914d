"""Timing instrumentation of the controller, and the solver's spans and
counters.

Counterpart of ``iterative_learning_nmpc_tpu/utils/profiling.py``: the same
decorator and reports. On a CUDA device the clock is read only after the
device has finished the work queued so far (``torch.cuda.synchronize``), so
a timing covers the device work a call launched, not its enqueue.

Spans and solve records follow the profiler: they are on exactly while
``torch.profiler`` runs (``torch.autograd._profiler_enabled()``). A span
then enters ``record_function``, so that it lands in the profiler's trace
on the device trace's clock, and, inside a solve (``solve_record``), adds
``(name, parent index, t0_ns, t1_ns)`` of the host clock
(``perf_counter_ns``) to that solve's record; a span's self time is its
duration less the time its children cover. A process records one solve
at a time (the controller replans on a single worker thread). Off,
``span`` returns one shared object that does nothing. The counters (``COUNTERS``) are host ints
and always on, like the kernels' ``.launches``; take the difference of two
``counters()`` copies.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from functools import wraps
from typing import Dict, List

import numpy as np
import torch


COUNTERS: Dict[str, int] = dict.fromkeys((
    "solver.solves",                 # TrajOptSolver.solve calls
    "solver.al_passes",              # inner AL passes the batch ran
    "solver.problem_passes",         # B x passes: the problems computed
    "solver.active_problem_passes",  # the problems each pass advanced
    "solver.host_syncs",             # device -> host reads of the solve loop
), 0)

MAX_SOLVE_RECORDS = 1024
_records: deque = deque(maxlen=MAX_SOLVE_RECORDS)
_open: dict | None = None    # the record of the solve under way
_stack: List[int] = []       # indices of its spans that are open


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(COUNTERS)


def solve_records() -> deque:
    """The records of the solves made while tracing was on, oldest first
    (at most ``MAX_SOLVE_RECORDS``): each a dict of ``solve`` (its
    ``solver.solves`` count), ``B``, ``N``, ``routes``, ``counters`` (the
    solve's deltas) and ``spans`` [(name, parent index or -1, t0_ns,
    t1_ns)], its root ``sqp.solve`` first."""
    return _records


def clear_solve_records() -> None:
    _records.clear()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "_rf", "_rec", "_i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._rec = rec = _open
        if rec is not None:
            spans = rec["spans"]
            self._i = len(spans)
            spans.append([self.name, _stack[-1] if _stack else -1,
                          time.perf_counter_ns(), None])
            _stack.append(self._i)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec["spans"][self._i][3] = time.perf_counter_ns()
            _stack.pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context for the named stretch of host code: a ``record_function``
    and an entry of the open solve's record while the profiler runs, else
    a shared no-op. ``name`` is a fixed string, so spans sum by name."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name)


class _SolveRecord:
    __slots__ = ("_rec", "_before", "_span")

    def __init__(self, rec: dict, before: Dict[str, int]):
        self._rec, self._before = rec, before

    def __enter__(self):
        global _open
        _open = self._rec
        self._span = _Span("sqp.solve").__enter__()
        return self

    def __exit__(self, *exc):
        global _open
        self._span.__exit__(*exc)
        _open = None
        rec = self._rec
        rec["counters"] = {k: v - self._before[k] for k, v in COUNTERS.items()}
        rec["spans"] = [tuple(s) for s in rec["spans"]]
        _records.append(rec)
        return False


def solve_record(B: int, N: int, routes: dict):
    """Count one solve in ``solver.solves`` and return its context: while
    the profiler runs, its root span ``sqp.solve`` and a record of its
    spans and counter deltas, kept once it closes; else a shared no-op."""
    before = counters() if torch.autograd._profiler_enabled() else None
    COUNTERS["solver.solves"] += 1
    if before is None:
        return _NO_SPAN
    return _SolveRecord(dict(solve=COUNTERS["solver.solves"], B=B, N=N, routes=routes,
                             counters=None, spans=[]), before)


def _sync(obj) -> None:
    dev = getattr(obj, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_fn(name: str):
    """Append the wall-clock ms of each call into ``self.timings[name]``
    when the object has ``compute_timings`` set; syncs ``self.device``
    before both clock reads when it is a CUDA device. Each call is also
    the span ``name``."""

    def decorator(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not getattr(self, "compute_timings", False):
                with span(name):
                    return fn(self, *args, **kwargs)
            _sync(self)
            t0 = time.perf_counter()
            with span(name):
                out = fn(self, *args, **kwargs)
            _sync(self)
            dt_ms = (time.perf_counter() - t0) * 1.0e3
            if not hasattr(self, "timings"):
                self.timings = defaultdict(list)
            self.timings[name].append(dt_ms)
            return out

        return wrapper

    return decorator


def print_timings(timings: Dict[str, List[float]]) -> None:
    """mean / std / max over the calls after the first, and the first
    call (it carries the one-time set-up) on its own."""
    for name, values in timings.items():
        if not values:
            continue
        first, rest = values[0], values[1:]
        print(f"-- {name}")
        if rest:
            arr = np.asarray(rest)
            print(f"   mean {arr.mean():.3f} ms | std {arr.std():.3f} ms | "
                  f"max {arr.max():.3f} ms | calls {len(rest)}")
        print(f"   first call: {first:.3f} ms")


def summarize_timings(timings: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
    """Machine-readable variant of ``print_timings``."""
    out = {}
    for name, values in timings.items():
        if not values:
            continue
        rest = np.asarray(values[1:]) if len(values) > 1 else np.asarray(values)
        out[name] = dict(mean_ms=float(rest.mean()), std_ms=float(rest.std()),
                         max_ms=float(rest.max()), first_ms=float(values[0]),
                         calls=len(values))
    return out


def cuda_time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` on the current CUDA card: one warm-up
    call, then ``reps`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn`` on the current CUDA card: ``reps`` calls
    captured in one CUDA graph, replayed ``replays`` times between two CUDA
    events, so the host's cost of a call (a wrapper's checks, the launch)
    is not in the time; what ``fn`` reads stays in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
