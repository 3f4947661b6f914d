"""Plan interpolation to the control rate, on the solver's device.

Counterpart of ``iterative_learning_nmpc_tpu/mpc/interpolate.py``: cubic
Hermite interpolation of (q, v) at the control rate and the zero-order-hold
index of the inputs, computed where the plan lives, so that a replan crosses
to the host once.
"""
from __future__ import annotations

import torch


def hermite_interp(t_knots: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                   t_query: torch.Tensor) -> torch.Tensor:
    """Cubic Hermite interpolation: knots (K,) strictly increasing, values
    and derivatives (..., K, D) with any leading batch dims (one per
    environment; the knots are shared), queries (T,) clipped into the knot
    range -> (..., T, D)."""
    K = t_knots.shape[0]
    tq = torch.clamp(t_query, t_knots[0], t_knots[-1])
    idx = torch.clamp(torch.searchsorted(t_knots, tq, right=True) - 1, 0, K - 2)
    t0, t1 = t_knots[idx], t_knots[idx + 1]
    h = torch.clamp_min(t1 - t0, 1e-9)
    s = ((tq - t0) / h)[:, None]
    y0, y1 = y[..., idx, :], y[..., idx + 1, :]
    d0, d1 = dy[..., idx, :], dy[..., idx + 1, :]
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s * s * (3 - 2 * s)
    h11 = s * s * (s - 1)
    return h00 * y0 + h10 * (h[:, None] * d0) + h01 * y1 + h11 * (h[:, None] * d1)


def interpolate_plan(q_sol, v_sol, a_sol, dt_sol, n_interp: int):
    """(q_plan, v_plan, id_repeat): q Hermite-interpolated with derivative
    v, v with derivative a (a's first row repeated), at n_interp uniform
    steps after the initial state; id_repeat the zero-order-hold node index
    of each step for the inputs. q_sol, v_sol (..., N+1, D) and a_sol
    (..., N, D) may carry leading batch dims; the node durations dt_sol
    (N,) are shared."""
    N = a_sol.shape[-2]
    t_knots = torch.cat([torch.zeros(1, dtype=dt_sol.dtype, device=dt_sol.device),
                         torch.cumsum(dt_sol, 0)])
    t_query = torch.linspace(float(t_knots[0]), float(t_knots[-1]), n_interp + 1,
                             dtype=dt_sol.dtype, device=dt_sol.device)[1:]
    q_plan = hermite_interp(t_knots, q_sol, v_sol, t_query)
    v_plan = hermite_interp(t_knots, v_sol, torch.cat([a_sol[..., :1, :], a_sol], dim=-2),
                            t_query)
    id_repeat = (torch.linspace(0.0, 1.0, n_interp, device=dt_sol.device)
                 * (N - 1)).to(torch.int64)
    return q_plan, v_plan, id_repeat
