"""Phase-aligned cold boot of the NMPC solver.

Counterpart of ``contact_windows`` and ``merit_phase_boot`` in
``iterative_learning_nmpc_tpu/solver/warmstart.py``. At a cold boot the
gait-phase offset of the contact schedule is free (nothing has been promised
to the plant yet), and it moves the converged solution a lot: the boot
probes every offset with one batched solve and keeps the best.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ocp.problem import OCPParams


def contact_windows(planner, N: int) -> np.ndarray:
    """(C, 4, N+1) contact windows at every gait-phase offset, one per
    planner start node over a cycle."""
    C = planner.nodes_per_cycle
    return np.stack([planner.get_contacts(o, N + 1) for o in range(C)]
                    ).astype(np.float32)


def peak_windows(planner, N: int) -> np.ndarray:
    """(C, 4, N+1) swing-peak windows matching ``contact_windows``."""
    C = planner.nodes_per_cycle
    return np.stack([planner.get_peaks(o, N + 1) for o in range(C)]
                    ).astype(np.float32)


def merit_phase_boot(solver, params: OCPParams, windows, probe_iters: int = 3,
                     peaks=None):
    """Pick the gait-phase offset that best fits the current state: ONE
    batch of C problems (one per contact window, cold-started) solved for
    ``probe_iters`` iterations, argmin of the merit.

    ``params`` is a batch of one; ``peaks`` are the swing-peak windows
    (default ``1 - windows``; the controller passes the planner's own when
    it optimizes the peaks). Returns (params', offset, probe_costs (C,)),
    params' carrying the selected windows.
    """
    dev, dtype = params.x0.device, params.x0.dtype
    w = torch.as_tensor(np.asarray(windows), dtype=dtype, device=dev)
    pk = 1.0 - w if peaks is None else torch.as_tensor(np.asarray(peaks),
                                                       dtype=dtype, device=dev)
    C = w.shape[0]
    pc = params.map(lambda t: t.expand((C,) + t.shape[1:]).contiguous())
    pc = pc.replace(cnt=w, peak=pk)
    X, U = solver.cold_start(pc)
    costs = solver.solve(X, U, pc, probe_iters).stats.cost
    off = int(torch.argmin(costs))
    return params.replace(cnt=w[off:off + 1], peak=pk[off:off + 1]), off, costs
