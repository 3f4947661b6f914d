"""The goal-conditioned policy network: its training half, its payloads
and its batched serving step.

Counterpart of ``iterative_learning_nmpc_tpu/learning/network.py``: Dense
-> [BatchNorm] -> [Dropout] -> ReLU, ``num_hidden_layer`` times, then a
final Dense; the deployed configuration is 47 -> 512x3 -> 12 with batch
norm. ``GoalConditionedPolicyNet`` trains as the Flax module does (BatchNorm
with Flax's biased batch variance and running averages, dropout active in
``train()`` only), and ``init_network`` draws Flax's initial weights.

Payloads are the JAX package's pickles, {variables (Flax layout),
norm_policy_input, net_config}, plain dicts of numpy arrays:
``save_policy`` writes them and ``load_policy`` reads them without JAX, so a
policy trained in either package loads in the other.

Serving (``ServedPolicy``): the state columns 1: and the goal are
normalised with the payload's statistics (the phase column passes through;
a standard deviation <= 1e-8 counts as 1), the BatchNorm layers are folded
into the Dense weights once, on the device, and the route is chosen once,
by shape: kernel 8 (``ops.policy_pd``, the fused MLP + PD kernel on a CUDA
device, its plain twin on the CPU) for the widths it takes
(``ops.policy_pd.kernel_takes``), and the fp32 addmm chain
(``ops.policy_pd.policy_pd_dense``) for every other net, as the JAX
package serves any net. ``make_policy_apply`` wraps one as the JAX
package's apply function, over any leading dims.
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


class FlaxBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose training mode is Flax's ``BatchNorm``
    (``use_fast_variance``): the batch is normalised with the biased
    variance max(0, E[x^2] - E[x]^2), and the running statistics move as
    0.9 old + 0.1 batch with that same variance (``nn.BatchNorm1d`` would
    keep the unbiased one). Eval mode reads the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(0)
        var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GoalConditionedPolicyNet(nn.Module):
    """The policy MLP. In eval mode ``forward`` is the Flax module's
    ``apply(..., train=False)``; in training mode its ``apply(...,
    train=True, mutable=["batch_stats"])``: BatchNorm on the batch's
    statistics (``FlaxBatchNorm``), then dropout at ``dropout_rate`` (kept
    units scaled by 1 / (1 - rate)), whose bits come from
    ``dropout_generator`` when it is set (a ``torch.Generator`` on the
    net's device), else from torch's default generator."""

    def __init__(self, input_size: int, output_size: int, num_hidden_layer: int = 4,
                 hidden_dim: int = 256, batch_norm: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        assert num_hidden_layer > 0
        self.net_config = dict(input_size=input_size, output_size=output_size,
                               num_hidden_layer=num_hidden_layer, hidden_dim=hidden_dim,
                               batch_norm=batch_norm, dropout_rate=dropout_rate)
        self.dropout_rate = float(dropout_rate)
        self.dropout_generator = None
        dims = [input_size] + [hidden_dim] * num_hidden_layer + [output_size]
        self.dense = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                   for i in range(num_hidden_layer + 1))
        # Flax's BatchNorm: eps 1e-5, running average momentum 0.9 (torch 0.1)
        self.norm = nn.ModuleList(FlaxBatchNorm(hidden_dim, eps=1e-5, momentum=0.1)
                                  for _ in range(num_hidden_layer if batch_norm else 0))

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout_rate <= 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, device=x.device, generator=self.dropout_generator) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, dense in enumerate(self.dense[:-1]):
            x = dense(x)
            if len(self.norm):
                x = self.norm[i](x)
            x = torch.relu(self._dropout(x))
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


def init_network(input_size: int, output_size: int, num_hidden_layer: int = 3,
                 hidden_dim: int = 512, batch_norm: bool = True, dropout_rate: float = 0.0,
                 generator=None, device=None) -> GoalConditionedPolicyNet:
    """A fresh net in training mode on ``device`` (by default the CUDA
    card), initialised as the Flax module is: every Dense weight from
    ``variance_scaling(2.0, "fan_in", "normal")``, an untruncated normal of
    std sqrt(2 / fan_in) (``kaiming_normal_`` on the (out, in) weight),
    biases 0, BatchNorm scale 1, bias 0, mean 0, var 1. The draws come from
    ``generator`` (a CPU ``torch.Generator``; torch's default one when
    None), so one seed gives the same weights on every device."""
    net = GoalConditionedPolicyNet(input_size, output_size, num_hidden_layer, hidden_dim,
                                   batch_norm, dropout_rate)
    with torch.no_grad():
        for dense in net.dense:
            nn.init.kaiming_normal_(dense.weight, mode="fan_in", nonlinearity="relu",
                                    generator=generator)
            dense.bias.zero_()
    return net.train().to(resolve_device(device))


def _numpy_tree(tree, dtype=None):
    """The nest of dicts, lists and tuples with every tensor or array leaf
    as a numpy array (of ``dtype`` when given); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) or dtype is not None:
        return np.asarray(tree, dtype)
    return tree


def save_policy(path: str, variables_or_net, norm_policy_input=None, net_config=None) -> str:
    """Write the payload the controllers load, in the JAX package's layout:
    {"variables": {"params": {Dense_i: {kernel (in, out), bias},
    BatchNorm_i: {scale, bias}}, "batch_stats": {BatchNorm_i: {mean, var}}},
    "norm_policy_input": [...], "net_config": {...}}, every weight a numpy
    float32 array and no torch object in the pickle. ``variables_or_net`` is
    a ``GoalConditionedPolicyNet`` (whose ``net_config`` is the default) or
    a Flax-layout variables dict."""
    if isinstance(variables_or_net, nn.Module):
        variables = variables_or_net.flax_variables()
        if net_config is None:
            net_config = dict(variables_or_net.net_config)
    else:
        variables = _numpy_tree(variables_or_net, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"variables": variables, "norm_policy_input": _numpy_tree(norm_policy_input),
               "net_config": net_config or {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def save_policy_bundle(path: str, entries) -> str:
    """A goal-scheduled bundle, ``entries`` = [(goal_vec, payload_path)]: a
    deployment serves the member whose training goal is nearest its
    commanded v_des (``load_policy(path, v_des)``)."""
    bundle = []
    for goal, p in entries:
        with open(p, "rb") as f:
            payload = pickle.load(f)
        bundle.append({"goal": [float(g) for g in goal], "payload": payload,
                       "source": os.path.basename(p)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"bundle": bundle}, f)
    return path


def _nearest_member(entries, v_des) -> int:
    """The index of the bundle member whose training goal is nearest v_des."""
    v = np.asarray(v_des, np.float64).reshape(-1)[:3]
    d = [float(np.linalg.norm(np.asarray(e["goal"], np.float64)[: len(v)] - v))
         for e in entries]
    return int(np.argmin(d))


def read_payload(path: str, v_des=None) -> dict:
    """The payload dict of a policy pickle. A goal-scheduled bundle gives
    the member whose training goal is nearest ``v_des``; without ``v_des``
    it warns and gives the first member."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "bundle" not in payload:
        return payload
    entries = payload["bundle"]
    if v_des is None:
        warnings.warn(
            f"load_policy({os.path.basename(path)}): goal-scheduled "
            f"bundle loaded without v_des - falling back to the first "
            f"member (goal {entries[0]['goal']}). Pass v_des to select "
            "a member explicitly.", stacklevel=3)
        return entries[0]["payload"]
    return entries[_nearest_member(entries, v_des)]["payload"]


def payload_members(path: str, goals):
    """The payloads that serve a batch of goals (E, 3): (payloads, member
    (E,)), row e served by ``payloads[member[e]]``, the bundle member
    nearest that row's goal as ``read_payload`` picks it; a plain payload
    serves every row."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    goals = np.asarray(goals, np.float64).reshape(-1, 3)
    if "bundle" not in payload:
        return [payload], np.zeros(len(goals), np.int64)
    entries = payload["bundle"]
    idx = np.array([_nearest_member(entries, g) for g in goals], np.int64)
    used = np.unique(idx)
    return [entries[i]["payload"] for i in used], np.searchsorted(used, idx)


def load_policy(path: str, v_des=None, device=None):
    """(net, norm) from a payload pickle: net a GoalConditionedPolicyNet in
    eval mode on ``device``, norm the payload's (mu_s, sigma_s, mu_g,
    sigma_g) as float32 tensors there, or None. Bundles as ``read_payload``."""
    from ..interop import policy_from_numpy

    return policy_from_numpy(read_payload(path, v_des), device=device)


def make_numpy_apply(path: str, v_des=None):
    """A numpy-only batched policy forward (B, 44 + 3) -> (B, 12) in float64,
    with the payload's normalisation folded in, for host loops that must
    not touch the device."""
    payload = read_payload(path, v_des)
    cfg = payload.get("net_config", {})
    n_hidden, batch_norm = cfg.get("num_hidden_layer", 3), cfg.get("batch_norm", True)
    norm = payload.get("norm_policy_input")
    if norm is None:
        norm = (np.zeros(44), np.ones(44), np.zeros(3), np.ones(3))
    mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float64) for x in norm]
    sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)
    sd_g = np.where(sd_g > 1e-8, sd_g, 1.0)
    params = _numpy_tree(payload["variables"]["params"], np.float64)
    stats = _numpy_tree(payload["variables"].get("batch_stats", {}), np.float64)

    def apply_fn(x):
        h = np.array(x, np.float64)
        h[:, 1:44] = (h[:, 1:44] - mu_s[1:]) / sd_s[1:]
        h[:, 44:] = (h[:, 44:] - mu_g) / sd_g
        for i in range(n_hidden):
            d = params[f"Dense_{i}"]
            h = h @ d["kernel"] + d["bias"]
            if batch_norm:
                b, s = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
                h = (h - s["mean"]) / np.sqrt(s["var"] + 1e-5) * b["scale"] + b["bias"]
            h = np.maximum(h, 0.0)
        d = params[f"Dense_{n_hidden}"]
        return h @ d["kernel"] + d["bias"]

    return apply_fn


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
        return self.serve(self.normalize(state44, goal), qj, vj, kp, kd)

    def serve(self, x, qj, vj, kp: float, kd: float):
        """``__call__`` on inputs (B, 47) already normalised."""
        return self._serve(self.layers, kp, kd, x, qj, vj)


def make_policy_apply(path: str, v_des=None, device=None):
    """A (..., 47) -> (..., 12) tensor function: the payload's PD targets
    with its normalisation folded in (state columns 1: and goal; the phase
    column passes through), served by ``ServedPolicy`` on ``device`` (by
    default the CUDA card), so through kernel 8 where its route is
    "kernel". Bundles as ``read_payload``."""
    from ..solver.warmstart import policy_targets

    targets = policy_targets(ServedPolicy(*load_policy(path, v_des=v_des, device=device),
                                          device=device))

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        return targets(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1] + (12,))

    return apply_fn
