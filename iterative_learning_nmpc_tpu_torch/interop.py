"""numpy -> port converters, so the port and the JAX package compute from
the same numbers. Every input is read through ``np.asarray``: pass numpy
arrays or any array object numpy can read (this module imports no JAX).

The system's "weights" are the robot spec, the cost weights, the OCP
parameters, the warm-start state (X, U, lam_eq, lam_ineq), for the closed
loop the plant's contact parameters and state and the controller's warm
start, and the learned policy's payload. Tensors go to ``device``, by
default the CUDA card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .learning.network import GoalConditionedPolicyNet
from .ocp.problem import OCPParams, Weights
from .robots.spec import _TENSOR_FIELDS, PAYLOAD_FIELDS, RobotSpec
from .sim.device_sim import ContactParams, SimState


def _t(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device(device))


def spec_from_numpy(src, device=None) -> RobotSpec:
    """RobotSpec from an object with the spec's fields (metadata + arrays).
    A payload-randomized spec (the JAX package's ``randomize_payload``:
    ``mass`` (B, nv), ``com`` (B, nv, 3)) keeps its batch, which the port's
    dynamics and plant broadcast; any other field must be nominal."""
    meta = {f: getattr(src, f) for f in
            ("name", "nv", "nu", "parent", "jtype", "foot_body",
             "feet_frame_names")}
    meta = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in meta.items()}
    spec = RobotSpec(**meta, **{f: _t(getattr(src, f), device)
                                for f in _TENSOR_FIELDS})
    nominal = {"joint_axis": 2, "joint_pos": 2, "mass": 1, "com": 2, "inertia": 3,
               "foot_offset": 2, "foot_radius": 0, "torque_limit": 1, "q_home": 1,
               "joint_limits": 2}
    lead = spec.batch_shape
    for f, nd in nominal.items():
        extra = getattr(spec, f).shape[:getattr(spec, f).dim() - nd]
        if extra != (lead if f in PAYLOAD_FIELDS else ()):
            raise ValueError(f"spec field {f} of shape {tuple(getattr(spec, f).shape)}: only "
                             f"{PAYLOAD_FIELDS} may carry a per-environment batch, the same one")
    return spec


def weights_from_numpy(src, device=None) -> Weights:
    return Weights(**{f.name: _t(getattr(src, f.name), device)
                      for f in dataclasses.fields(Weights)})


def params_from_numpy(src, device=None) -> OCPParams:
    """OCPParams from an object with the OCPParams fields. A single problem
    (x0 of shape (36,)) becomes a batch of one."""
    single = np.asarray(src.x0).ndim == 1
    return OCPParams(**{
        f.name: (_t(getattr(src, f.name), device)[None] if single
                 else _t(getattr(src, f.name), device))
        for f in dataclasses.fields(OCPParams)})


def warm_start_from_numpy(X, U, lam_eq, lam_ineq, device=None):
    """(X, U, lam_eq, lam_ineq) tensors; unbatched arrays gain a batch dim."""
    out = []
    for a, nd in ((X, 2), (U, 2), (lam_eq, 2), (lam_ineq, 2)):
        t = _t(a, device)
        out.append(t[None] if t.dim() == nd else t)
    return tuple(out)


def contact_params_from_numpy(src, device=None) -> ContactParams:
    """Plant contact parameters from an object with their fields."""
    return ContactParams(**{f.name: _t(getattr(src, f.name), device)
                            for f in dataclasses.fields(ContactParams)})


def sim_state_from_numpy(q, v, t=0.0, device=None) -> SimState:
    """Plant state (q, v, t) in the Euler chart."""
    return SimState(_t(q, device), _t(v, device), _t(t, device))


def policy_from_numpy(payload, device=None):
    """(net, norm) from a policy payload dict {variables (Flax layout),
    norm_policy_input, net_config}: the GoalConditionedPolicyNet in eval
    mode on ``device`` (Dense_i.kernel (in, out) -> Linear.weight (out, in);
    BatchNorm_i scale, bias, mean, var -> weight, bias, running_mean,
    running_var) and the norm stats as float32 tensors, or None."""
    dev = resolve_device(device)
    cfg = payload.get("net_config", {})
    net = GoalConditionedPolicyNet(
        input_size=cfg.get("input_size", 47),
        output_size=cfg.get("output_size", 12),
        num_hidden_layer=cfg.get("num_hidden_layer", 3),
        hidden_dim=cfg.get("hidden_dim", 512),
        batch_norm=cfg.get("batch_norm", True),
        dropout_rate=cfg.get("dropout_rate", 0.0))
    params = payload["variables"]["params"]
    stats = payload["variables"].get("batch_stats", {})
    with torch.no_grad():
        for i, dense in enumerate(net.dense):
            dense.weight.copy_(_t(params[f"Dense_{i}"]["kernel"], "cpu").T)
            dense.bias.copy_(_t(params[f"Dense_{i}"]["bias"], "cpu"))
        for i, bn in enumerate(net.norm):
            bn.weight.copy_(_t(params[f"BatchNorm_{i}"]["scale"], "cpu"))
            bn.bias.copy_(_t(params[f"BatchNorm_{i}"]["bias"], "cpu"))
            bn.running_mean.copy_(_t(stats[f"BatchNorm_{i}"]["mean"], "cpu"))
            bn.running_var.copy_(_t(stats[f"BatchNorm_{i}"]["var"], "cpu"))
    norm = payload.get("norm_policy_input")
    if norm is not None:
        norm = tuple(_t(x, dev) for x in norm)
    return net.eval().to(dev), norm


def random_policy_payload(n_hidden: int, width, seed: int, q_stand=None) -> dict:
    """A seeded policy payload in the JAX package's layout (Flax variables
    with batch norm and random running statistics, no input statistics,
    net_config) of 47 -> width x n_hidden -> 12 (``width`` an int, or one
    width per hidden layer), for tests and the smoke run. With ``q_stand``
    (12 joint angles), the last layer's weights are scaled by 1e-2 and its
    bias is q_stand, so that the policy holds the stance."""
    rng = np.random.default_rng(seed)
    widths = (width,) * n_hidden if isinstance(width, int) else tuple(width)
    dims = (47,) + widths + (12,)
    params, stats = {}, {}
    for i in range(n_hidden + 1):
        params[f"Dense_{i}"] = {"kernel": rng.normal(0, dims[i] ** -0.5, dims[i:i + 2]),
                                "bias": rng.normal(0, 0.1, dims[i + 1])}
        if i < n_hidden:
            h = dims[i + 1]
            params[f"BatchNorm_{i}"] = {"scale": rng.uniform(0.5, 1.5, h),
                                        "bias": rng.normal(0, 0.1, h)}
            stats[f"BatchNorm_{i}"] = {"mean": rng.normal(0, 0.1, h),
                                       "var": rng.uniform(0.5, 2.0, h)}
    if q_stand is not None:
        last = params[f"Dense_{n_hidden}"]
        last["kernel"] *= 1e-2
        last["bias"] = np.asarray(q_stand, np.float64)
    cfg = dict(input_size=47, output_size=12, num_hidden_layer=n_hidden, hidden_dim=width,
               batch_norm=True, dropout_rate=0.0)
    return {"variables": {"params": params, "batch_stats": stats}, "norm_policy_input": None,
            "net_config": cfg}


def controller_state_from_numpy(mpc, X, U, lam_eq, lam_ineq) -> None:
    """Give a ``LocomotionMPC`` the warm start (X_prev, U_prev, lam,
    lami) of its next replan, on its device."""
    (mpc._X_prev, mpc._U_prev, mpc._lam_prev,
     mpc._lami_prev) = warm_start_from_numpy(X, U, lam_eq, lam_ineq, device=mpc.device)
