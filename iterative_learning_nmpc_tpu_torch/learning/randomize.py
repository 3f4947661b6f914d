"""Domain randomization for batched datagen: per-environment payloads,
terrain and push schedules ("terrain/payload randomization, sharded
aggregation").

Counterpart of ``iterative_learning_nmpc_tpu/learning/randomize.py`` with
an explicit ``torch.Generator`` (a CPU generator: the samples are drawn on
the CPU and moved to ``device``, so one seed gives the same numbers on any
device). A payload is a spec whose ``mass`` (B, 18) and ``com`` (B, 18, 3)
carry the batch (``payload_spec_axes``); the port's dynamics and plant
broadcast it against the state's batch, where the JAX package maps its
spec with ``jax.vmap``. ``make_batched_mpc_rollout`` gives such a spec to
the plant alone: the controller's model stays nominal (model-plant
mismatch by design).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device
from ..robots.spec import _TENSOR_FIELDS, PAYLOAD_FIELDS, RobotSpec
from ..sim.device_sim import ContactParams, default_contact_params


class TerrainParams(NamedTuple):
    ground_height: torch.Tensor   # (B,)
    contact: ContactParams        # fields (B,)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def payload_spec(spec: RobotSpec, extra, shift) -> RobotSpec:
    """The nominal ``spec`` with a payload per environment: ``extra`` (B,)
    kg added to the trunk (body 5), whose CoM moves in x and y by ``shift``
    (B, 2) m weighted by the payload's share extra / (m_trunk + extra)."""
    extra = torch.as_tensor(extra, dtype=spec.mass.dtype, device=spec.device)
    shift = torch.as_tensor(shift, dtype=spec.com.dtype, device=spec.device)
    n = extra.shape[0]
    mass = spec.mass.expand((n,) + spec.mass.shape).clone()
    mass[:, 5] += extra
    com = spec.com.expand((n,) + spec.com.shape).clone()
    w_extra = (extra / (spec.mass[5] + extra))[:, None]
    com[:, 5, :2] += w_extra * shift
    return dataclasses.replace(spec, mass=mass, com=com)


def randomize_payload(
    spec: RobotSpec,
    gen: torch.Generator,
    n: int,
    mass_range: Tuple[float, float] = (0.0, 3.0),
    com_shift: float = 0.03,
) -> RobotSpec:
    """A spec with ``n`` per-env payloads on ``spec``'s device: the extra
    trunk mass uniform in ``mass_range``, the CoM shift uniform in
    +-``com_shift`` in x and y (``payload_spec``)."""
    extra = _uniform(gen, (n,), *mass_range)
    shift = _uniform(gen, (n, 2), -com_shift, com_shift)
    return payload_spec(spec, extra, shift)


def payload_spec_axes(spec: RobotSpec) -> RobotSpec:
    """Which fields of a payload spec carry the batch, in the JAX package's
    ``in_axes`` form: 0 for ``mass`` and ``com``, None for every other."""
    return dataclasses.replace(spec, **{f: (0 if f in PAYLOAD_FIELDS else None)
                                        for f in _TENSOR_FIELDS})


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
