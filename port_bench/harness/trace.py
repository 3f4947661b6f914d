"""The traced run's reading of the device: ``torch.profiler`` (CPU and CUDA
activity) over a steady stretch of steps in the middle of the window.

The profile is exported as a Chrome trace into the run's temporary
directory, read back and deleted. From it:

- device activity: every kernel, copy and set (``cat`` kernel, gpu_memcpy,
  gpu_memset) inside the stretch, the stretch being from the start of the
  first traced step's ``rti.step`` annotation to the end of the last;
- ``busy_s``: the union of that activity; ``window_s``: the stretch;
- kernel time and calls by name (the function name before its argument
  list, without a template's arguments);
- idle gaps: each stretch of the window with no device activity, labelled
  with the innermost host operation under way at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def kernel_name(full: str) -> str:
    """'void ns::k<3>(float const*, int)' -> 'k'."""
    head = full.replace("(anonymous namespace)", "").split("(")[0]
    head = re.sub(r"<.*>", "", head).strip()
    return head.split()[-1].split("::")[-1] if head else full


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds on the card) falls in set-up and not in a traced step."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)


class Tracer:
    """Starts the profiler at the first step that begins after ``start_s``
    of the window and stops it after ``steps`` steps; ``busy`` while the
    stretch is open, so that the window does not close inside it."""

    def __init__(self, steps: int, start_s: float):
        self.want, self.start_s = steps, start_s
        self.prof, self.region, self.traced, self.done = None, None, [], False

    @property
    def busy(self) -> bool:
        return self.prof is not None and not self.done

    def before_step(self, n: int, now: float):
        import torch

        if self.done:
            return
        if self.prof is None and now >= self.start_s:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        if self.prof is not None:
            self.region = torch.profiler.record_function("rti.step")
            self.region.__enter__()

    def after_step(self, n: int):
        if self.region is None:
            return
        self.region.__exit__(None, None, None)
        self.region = None
        self.traced.append(n)
        if len(self.traced) >= self.want:
            self.prof.__exit__(None, None, None)
            self.done = True

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        if not self.done:
            self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        events = events["traceEvents"] if isinstance(events, dict) else events
        out = reduce_events(events)
        out["traced_steps"] = list(self.traced)
        return out


def reduce_events(events: list) -> dict:
    """Device busy time, kernel sums and idle gaps of a Chrome trace whose
    steps carry ``rti.step`` annotations."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in xs if e.get("name") == "rti.step" and e.get("cat") == "user_annotation"]
    if not steps:
        return dict(busy_s=0.0, window_s=0.0, kernels={}, idle={}, steps=0)
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                  for e in xs if e.get("cat") in DEVICE_CATS
                  and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0),
                 key=lambda t: (t[0], t[1]))
    kernels = defaultdict(lambda: [0.0, 0])
    busy, gaps, cur = 0.0, [], w0
    for a, b, e in dev:
        a, b = max(a, w0), min(b, w1)
        if e.get("cat") == "kernel":
            k = kernels[kernel_name(e["name"])]
            k[0] += (b - a) * 1e-6
            k[1] += 1
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in xs if e.get("cat") in HOST_CATS and e.get("name") != "rti.step")
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        # the innermost operation under way starts shortly before the middle
        under = [h for h in host[max(0, i - 400):i] if h[1] >= mid]
        label = min(under, key=lambda h: h[1] - h[0])[2] if under else "host between ops"
        idle[label] += (b - a) * 1e-6
    return dict(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6, steps=len(steps),
                kernels={k: tuple(v) for k, v in kernels.items()}, idle=dict(idle))
