"""One run of one cell: set-up, the measured window, the check.

The window drives the port's warm RTI chain step by step. Each step ends
with the read-back a data generator makes (every problem's merit, pass
count and whether its cost and trajectory are finite, in one copy) and a
``torch.cuda.synchronize()``. A step's time is read from CUDA events
recorded before the step and after the read-back; the window's length from
the host clock around all of it.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import inputs as ref_inputs
from ..reference.robot import load_robot
from . import check, program
from .trace import Tracer, warm_profiler

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Per-step device time by CUDA events; host time on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pairs, self.host = [], []

    def start(self):
        self.t = time.perf_counter()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ev = ev

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append((self.ev, ev))
        self.host.append(time.perf_counter() - self.t)

    def step_ms(self) -> np.ndarray:
        if self.cuda:
            return np.array([a.elapsed_time(b) for a, b in self.pairs])
        return 1e3 * np.array(self.host)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        step_fn=None, record_steps=None) -> dict:
    """Everything a result line needs. ``step_fn`` stands in for
    ``program.rti_step`` (the control and the fault tests replace it);
    ``record_steps`` records the first that many window steps for the check
    instead of steps at times drawn from the seed."""
    step_fn = step_fn or program.rti_step
    tr = cell.traffic
    B, P = tr["batch"], tr["check"]["problems"]
    rob = cell.config["robot"]
    robot64 = load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"],
                         rob["base_height_home"])
    nom = ref_inputs.nominal_problem(cell.opt, cell.config["gait"], tr["motion"], robot64)
    solver, _ = program.build_solver(cell, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(B, 36, generator=gen, device=device, dtype=torch.float32)
    x0 = torch.as_tensor(nom["x0"], dtype=torch.float32, device=device) + tr["x0_noise_std"] * noise
    params = program.make_params(solver, nom, x0)
    X, U = solver.cold_start(params)
    lam_eq, lam_ineq = params.lam_eq, params.lam_ineq

    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.sort(rng.choice(B, P, replace=False)), device=device)
    # times in the window's first nine tenths, so that a step starts after each
    record_at = sorted(rng.uniform(0.0, 0.9 * seconds, tr["check"]["steps"]).tolist())
    if record_steps is not None:
        record_at = [0.0] * record_steps

    def take(X, U, le, li):
        return dict(X=X[idx].clone(), U=U[idx].clone(), lam_eq=le[idx].clone(),
                    lam_ineq=li[idx].clone())

    def step(X, U, le, li):
        X, U, le, li, st = step_fn(solver, X, U, le, li, params)
        fin = (torch.isfinite(st.cost) & torch.isfinite(X).flatten(1).all(1)
               & torch.isfinite(U).flatten(1).all(1))
        back = torch.stack([st.cost, st.qp_iters.to(st.cost.dtype), fin.to(st.cost.dtype)]).cpu()
        return X, U, le, li, st, back

    # set-up: the start recorded, then the warm-up steps (the first builds
    # and loads the kernels)
    first = dict(x0=x0[idx].clone(), **{"in": take(X, U, lam_eq, lam_ineq)})
    for i in range(tr["warmup_steps"]):
        X, U, lam_eq, lam_ineq, st, _ = step(X, U, lam_eq, lam_ineq)
        if i == 0:
            first["out"] = dict(take(X, U, lam_eq, lam_ineq), cost=st.cost[idx].clone(),
                                qp_iters=st.qp_iters[idx].clone())
    if trace:
        warm_profiler()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # the window
    clock, records, backs = _Clock(device), [], []
    tracer = Tracer(tr["trace"]["steps"], tr["trace"]["start_fraction"] * seconds) if trace else None
    launches0 = program.launch_counts()
    t0 = time.perf_counter()
    n = 0
    while True:
        now = time.perf_counter() - t0
        if (now >= seconds and not (tracer and tracer.busy)
                and not (record_steps and record_at)):
            break
        if tracer:
            tracer.before_step(n, now)
        rec = None
        if record_at and now >= record_at[0]:
            record_at.pop(0)
            rec = {"in": take(X, U, lam_eq, lam_ineq)}
        clock.start()
        X, U, lam_eq, lam_ineq, st, back = step(X, U, lam_eq, lam_ineq)
        _sync(device)
        clock.stop()
        backs.append(back)
        if rec is not None:
            rec["out"] = dict(take(X, U, lam_eq, lam_ineq), cost=st.cost[idx].clone(),
                              qp_iters=st.qp_iters[idx].clone())
            records.append(rec)
        if tracer:
            tracer.after_step(n)
        n += 1
    window_s = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in program.launch_counts().items()}
    step_ms = clock.step_ms()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    backs = torch.stack(backs)                              # (steps, 3, B)
    failed = int((backs[:, 2] < 0.5).sum())
    traced = tracer.reduce() if tracer else None
    del X, U, lam_eq, lam_ineq, st, params, solver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the program's state is freed
    robot_dev = load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"],
                           rob["base_height_home"], dtype=torch.float64, device=device)
    t_check = time.perf_counter()
    numbers = check.compare(cell, robot_dev, nom, dict(first=first, steps=records), device)
    numbers["check_s"] = time.perf_counter() - t_check
    return dict(seed=seed, setup_s=setup_s, window_s=window_s, steps=n, batch=B,
                step_ms=step_ms, attempted=B * n, failed=failed, launches=launches,
                passes=backs[:, 1].amax(1).numpy(), memory_peak_bytes=int(peak),
                trace=traced, numbers=numbers, cell=cell, device=device)
