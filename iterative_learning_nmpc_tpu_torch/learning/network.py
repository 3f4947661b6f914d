"""The goal-conditioned policy network, its loader and its batched serving
step.

Counterpart of the serving part of
``iterative_learning_nmpc_tpu/learning/network.py``: Linear -> [BatchNorm]
-> ReLU, ``num_hidden_layer`` times, then a final Linear; the deployed
configuration is 47 -> 512x3 -> 12 with batch norm. Payloads are the JAX
package's pickles, {variables (Flax layout), norm_policy_input,
net_config}, plain dicts of numpy arrays: they load without JAX.

Serving (``ServedPolicy``): the state columns 1: and the goal are
normalised with the payload's statistics (the phase column passes through;
a standard deviation <= 1e-8 counts as 1), the BatchNorm layers are folded
into the Dense weights once, on the device, and the route is chosen once,
by shape: kernel 8 (``ops.policy_pd``, the fused MLP + PD kernel on a CUDA
device, its plain twin on the CPU) for the widths it takes
(``ops.policy_pd.kernel_takes``), and the fp32 addmm chain
(``ops.policy_pd.policy_pd_dense``) for every other net, as the JAX
package serves any net.
"""
from __future__ import annotations

import os
import pickle
import warnings

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.policy_pd import fold_batchnorm, kernel_takes, policy_pd, policy_pd_dense


class GoalConditionedPolicyNet(nn.Module):
    """The policy MLP; ``forward`` in eval mode matches the Flax module's
    ``apply(..., train=False)``. ``dropout_rate`` is kept in ``net_config``
    only: dropout acts in training, which this package does not port yet."""

    def __init__(self, input_size: int, output_size: int, num_hidden_layer: int = 4,
                 hidden_dim: int = 256, batch_norm: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        assert num_hidden_layer > 0
        self.net_config = dict(input_size=input_size, output_size=output_size,
                               num_hidden_layer=num_hidden_layer, hidden_dim=hidden_dim,
                               batch_norm=batch_norm, dropout_rate=dropout_rate)
        dims = [input_size] + [hidden_dim] * num_hidden_layer + [output_size]
        self.dense = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                   for i in range(num_hidden_layer + 1))
        # Flax's BatchNorm: eps 1e-5, running average momentum 0.9 (torch 0.1)
        self.norm = nn.ModuleList(nn.BatchNorm1d(hidden_dim, eps=1e-5, momentum=0.1)
                                  for _ in range(num_hidden_layer if batch_norm else 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, dense in enumerate(self.dense[:-1]):
            x = dense(x)
            if len(self.norm):
                x = self.norm[i](x)
            x = torch.relu(x)
        return self.dense[-1](x)

    def flax_variables(self) -> dict:
        """The weights in the Flax layout of the payloads, as numpy:
        Dense_i.kernel is (in, out), the transpose of Linear.weight."""
        npy = lambda t: np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)
        params, stats = {}, {}
        for i, dense in enumerate(self.dense):
            params[f"Dense_{i}"] = {"kernel": npy(dense.weight.T), "bias": npy(dense.bias)}
        for i, bn in enumerate(self.norm):
            params[f"BatchNorm_{i}"] = {"scale": npy(bn.weight), "bias": npy(bn.bias)}
            stats[f"BatchNorm_{i}"] = {"mean": npy(bn.running_mean),
                                       "var": npy(bn.running_var)}
        return {"params": params, "batch_stats": stats} if stats else {"params": params}


def load_policy(path: str, v_des=None, device=None):
    """(net, norm) from a payload pickle: net a GoalConditionedPolicyNet in
    eval mode on ``device``, norm the payload's (mu_s, sigma_s, mu_g,
    sigma_g) as float32 tensors there, or None. A goal-scheduled bundle
    gives the member whose training goal is nearest ``v_des``; without
    ``v_des`` it warns and gives the first member."""
    from ..interop import policy_from_numpy

    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "bundle" in payload:
        entries = payload["bundle"]
        if v_des is None:
            warnings.warn(
                f"load_policy({os.path.basename(path)}): goal-scheduled "
                f"bundle loaded without v_des - falling back to the first "
                f"member (goal {entries[0]['goal']}). Pass v_des to select "
                "a member explicitly.", stacklevel=2)
            payload = entries[0]["payload"]
        else:
            v = np.asarray(v_des, np.float64).reshape(-1)[:3]
            d = [float(np.linalg.norm(np.asarray(e["goal"], np.float64)[: len(v)] - v))
                 for e in entries]
            payload = entries[int(np.argmin(d))]["payload"]
    return policy_from_numpy(payload, device=device)


class ServedPolicy:
    """A policy folded for serving on one device: ``layers`` the
    BatchNorm-folded (W, b) float32 tensors, the guarded normalisation
    statistics, and ``route``, chosen here once by shape: "kernel" (kernel
    8; the twin on the CPU) for the widths it takes, "dense" (the fp32
    addmm chain) for every other net. A route rule, not a fallback: a
    kernel that fails to build or launch raises."""

    def __init__(self, weights, norm=None, device=None):
        """weights: a GoalConditionedPolicyNet or a Flax-layout variables
        dict; norm: (mu_s (44,), sigma_s (44,), mu_g, sigma_g) or None (no
        normalisation)."""
        dev = resolve_device(device)
        variables = (weights.flax_variables() if isinstance(weights, nn.Module)
                     else weights)
        self.layers = [(torch.as_tensor(np.ascontiguousarray(W), device=dev),
                        torch.as_tensor(b, device=dev)) for W, b in fold_batchnorm(variables)]
        f32 = lambda x: torch.as_tensor(np.asarray(
            x.cpu() if isinstance(x, torch.Tensor) else x, np.float32), device=dev)
        if norm is None:
            norm = (np.zeros(44), np.ones(44), 0.0, 1.0)
        s_mean, s_std, g_mean, g_std = (f32(x) for x in norm)
        guard = lambda sd: torch.where(sd > 1e-8, sd, torch.ones_like(sd))
        self.s_mean, self.s_std = s_mean, guard(s_std)
        self.g_mean, self.g_std = g_mean, guard(g_std)
        dims = [int(self.layers[0][0].shape[0])] + [int(W.shape[1]) for W, _ in self.layers]
        self.route = "kernel" if kernel_takes(dims) else "dense"
        self._serve = policy_pd if self.route == "kernel" else policy_pd_dense

    def normalize(self, state44: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """(..., 44) observations and (..., 3) goals -> (..., 47) inputs."""
        s = (state44[..., 1:] - self.s_mean[1:]) / self.s_std[1:]
        g = (goal - self.g_mean) / self.g_std
        return torch.cat([state44[..., :1], s, g], dim=-1)

    def __call__(self, state44, goal, qj, vj, kp: float, kd: float):
        """(act, tau) (B, 12): the PD targets and kp (act - qj) - kd vj, by
        ``route``."""
        return self._serve(self.layers, kp, kd, self.normalize(state44, goal), qj, vj)
