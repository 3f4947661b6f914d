"""Timing instrumentation of the controller.

Counterpart of ``iterative_learning_nmpc_tpu/utils/profiling.py``: the same
decorator and reports. On a CUDA device the clock is read only after the
device has finished the work queued so far (``torch.cuda.synchronize``), so
a timing covers the device work a call launched, not its enqueue.
"""
from __future__ import annotations

import time
from collections import defaultdict
from functools import wraps
from typing import Dict, List

import numpy as np
import torch


def _sync(obj) -> None:
    dev = getattr(obj, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_fn(name: str):
    """Append the wall-clock ms of each call into ``self.timings[name]``
    when the object has ``compute_timings`` set; syncs ``self.device``
    before both clock reads when it is a CUDA device."""

    def decorator(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not getattr(self, "compute_timings", False):
                return fn(self, *args, **kwargs)
            _sync(self)
            t0 = time.perf_counter()
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
