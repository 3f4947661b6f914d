"""Per-environment terrain and push schedules for batched datagen.

Counterpart of ``iterative_learning_nmpc_tpu/learning/randomize.py`` with
an explicit ``torch.Generator`` (a CPU generator: the samples are drawn on
the CPU and moved to ``device``, so one seed gives the same numbers on any
device). Payload randomization (``randomize_payload``) is not ported: it
needs a per-environment mass and CoM through the port's dynamics.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device
from ..sim.device_sim import ContactParams, default_contact_params


class TerrainParams(NamedTuple):
    ground_height: torch.Tensor   # (B,)
    contact: ContactParams        # fields (B,)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def randomize_terrain(
    gen: torch.Generator,
    n: int,
    height_range: Tuple[float, float] = (-0.02, 0.02),
    stiffness_range: Tuple[float, float] = (1.0e4, 4.0e4),
    friction_range: Tuple[float, float] = (0.5, 1.0),
    device=None,
) -> TerrainParams:
    """Per-env terrain: ground offset, contact stiffness, friction; damping
    and the tangential smoothing keep their defaults."""
    dev = resolve_device(device)
    base = default_contact_params(device=dev)
    height = _uniform(gen, (n,), *height_range).to(dev)
    stiffness = _uniform(gen, (n,), *stiffness_range).to(dev)
    mu = _uniform(gen, (n,), *friction_range).to(dev)
    return TerrainParams(
        ground_height=height,
        contact=ContactParams(stiffness=stiffness, damping=base.damping.expand(n),
                              friction_mu=mu, vel_smoothing=base.vel_smoothing.expand(n)))


def sample_force_windows(
    gen: torch.Generator,
    n: int,
    total_steps: int,
    magnitude_range: Tuple[float, float] = (50.0, 70.0),
    duration_range_s: Tuple[float, float] = (0.2, 0.4),
    sim_dt: float = 1.0e-3,
    device=None,
) -> torch.Tensor:
    """(n, 5) scheduled base pushes [start_step, end_step, fx, fy, fz] for
    ``make_batched_mpc_rollout``'s ``force_windows``: uniform magnitude and
    duration, uniform direction on the sphere, a start that keeps the
    window inside the rollout."""
    mag = _uniform(gen, (n,), *magnitude_range)
    d = torch.randn((n, 3), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    dur = _uniform(gen, (n,), *duration_range_s) / sim_dt
    start = torch.rand((n,), generator=gen) * torch.clamp_min(total_steps - dur, 1.0)
    return torch.cat([start[:, None], (start + dur)[:, None], mag[:, None] * d],
                     dim=1).to(resolve_device(device))
