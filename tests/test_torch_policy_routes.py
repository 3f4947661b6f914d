"""The policy serving routes of the port (``learning/network.ServedPolicy``,
``ops/policy_pd.kernel_takes`` and ``policy_pd_dense``) against the JAX
package, for nets other than the shipped one.

The JAX package serves any ``net_config`` in its rollouts (the Flax module
under ``vmap``); the port serves kernel 8's widths by the kernel and every
other net by the fp32 addmm chain. Two payloads made with the JAX
``GoalConditionedPolicyNet`` from a seed: 4 hidden layers of 256 (the
class default, no batch norm; route "dense") and 3 of 1024 (batch norm
with random statistics, so the folding is exercised; route "kernel" since
kernel 8 takes hidden widths up to 1024). Each is loaded by
``interop.policy_from_numpy``, served by ``ServedPolicy(device="cpu")``
and held to the JAX package's ``make_policy_apply`` under ``vmap``, run
eagerly (no ``jax.jit``, no Pallas). About 13 s of worker time on the
CPU, 8 s of it the two payloads' JAX init and first eager calls; the
1028-wide route cases add under 0.01 s (the port's test files summed
648.1 s of worker time before them and 433.7 s after, --durations=0, -n
6, on one 8-CPU host under other load). The
card's routes are tested in tests/test_torch_cuda_kernels.py, which
imports no JAX.
"""
import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.learning import network as jnetwork
from iterative_learning_nmpc_tpu_torch import interop
from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy
from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
    kernel_takes, policy_pd_dense, policy_pd_plain)

torch.set_num_threads(1)
KP, KD = 20.0, 1.5
B = 64
# hidden layers, width, batch norm, route
NETS = {"4x256": (4, 256, False, "dense"), "3x1024": (3, 1024, True, "kernel")}


def make_payload(name, seed):
    """A payload dict {variables, norm_policy_input, net_config} of the JAX
    GoalConditionedPolicyNet, its weights from init_network's Kaiming draw
    and its BatchNorm parameters, running statistics and input statistics
    from numpy."""
    n_hidden, width, bn, _ = NETS[name]
    cfg = dict(input_size=47, output_size=12, num_hidden_layer=n_hidden, hidden_dim=width,
               batch_norm=bn, dropout_rate=0.0)
    _, variables = jnetwork.init_network(jax.random.PRNGKey(seed), **cfg)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    for i in range(n_hidden + 1):
        d = variables["params"][f"Dense_{i}"]
        d["bias"] = f32(0.1 * rng.standard_normal(d["bias"].shape))
    if bn:
        for i in range(n_hidden):
            variables["params"][f"BatchNorm_{i}"] = {
                "scale": f32(1.0 + 0.2 * rng.standard_normal(width)),
                "bias": f32(0.1 * rng.standard_normal(width))}
            variables["batch_stats"][f"BatchNorm_{i}"] = {
                "mean": f32(0.1 * rng.standard_normal(width)),
                "var": f32(1.0 + 0.3 * rng.uniform(size=width))}
    norm = (f32(rng.standard_normal(44)), f32(0.5 + rng.uniform(size=44)),
            f32(rng.standard_normal(3)), f32(0.5 + rng.uniform(size=3)))
    return {"variables": variables, "norm_policy_input": norm, "net_config": cfg}


def _inputs(seed):
    """Observations (B, 44), goals (B, 3), joint q and v (B, 12)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 44)).astype(np.float32),
            rng.standard_normal((B, 3)).astype(np.float32),
            (0.5 * rng.standard_normal((B, 12))).astype(np.float32),
            rng.standard_normal((B, 12)).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(NETS))
def served_case(request, tmp_path_factory):
    """(name, payload, the JAX package's targets at _inputs(1))."""
    name = request.param
    payload = make_payload(name, seed=11)
    path = str(tmp_path_factory.mktemp("policy") / f"{name}.pkl")
    jnetwork.save_policy(path, payload["variables"], payload["norm_policy_input"],
                         payload["net_config"])
    s44, goal, _, _ = _inputs(1)
    apply_fn = jnetwork.make_policy_apply(path)
    a_ref = np.asarray(jax.vmap(apply_fn)(np.concatenate([s44, goal], 1)))
    return name, payload, a_ref


def test_served_policy_matches_jax_apply(served_case):
    """Loaded by policy_from_numpy and served on the CPU, on its route by
    shape (the 3 x 1024 net on "kernel", whose CPU path is the plain twin):
    the targets within 5e-5 of the Flax apply, as
    tests/test_torch_policy.py::test_served_policy_matches_jax_apply holds
    the shipped payload, and the torque kp times that."""
    name, payload, a_ref = served_case
    net, norm = interop.policy_from_numpy(payload, device="cpu")
    served = ServedPolicy(net, norm, device="cpu")
    n_hidden, width, _, route = NETS[name]
    assert served.route == route
    assert [tuple(W.shape) for W, _ in served.layers] == (
        [(47, width)] + [(width, width)] * (n_hidden - 1) + [(width, 12)])
    s44, goal, qj, vj = (torch.as_tensor(a) for a in _inputs(1))
    act, tau = served(s44, goal, qj, vj, KP, KD)
    np.testing.assert_allclose(act.numpy(), a_ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tau.numpy(), KP * (a_ref - qj.numpy()) - KD * vj.numpy(),
                               rtol=0, atol=KP * 5e-5)


def test_dense_route_equals_plain_twin(served_case):
    """policy_pd_dense is the addmm chain: on the same tensors it gives the
    twin's result exactly, and counts its calls."""
    _, payload, _ = served_case
    served = ServedPolicy(*interop.policy_from_numpy(payload, device="cpu"), device="cpu")
    s44, goal, qj, vj = (torch.as_tensor(a) for a in _inputs(2))
    x = served.normalize(s44, goal)
    n0 = policy_pd_dense.calls
    for a, b in zip(policy_pd_dense(served.layers, KP, KD, x, qj, vj),
                    policy_pd_plain(served.layers, KP, KD, x, qj, vj)):
        assert torch.equal(a, b)
    assert policy_pd_dense.calls == n0 + 1


@pytest.mark.parametrize("dims, takes", [
    ((47, 512, 512, 512, 12), True),            # the shipped policy
    ((47, 256, 256, 256, 12), True),
    ((47, 256, 256, 256, 256, 12), False),      # 5 layers (the JAX class default)
    ((47, 1024, 1024, 1024, 12), True),         # hidden 1024: the wide layout
    ((47, 1028, 1028, 1028, 12), False),        # hidden past 1024
    ((47, 512, 1028, 512, 12), False),
    ((47, 512, 512, 512, 65), False),           # n_out 65
    ((47, 250, 250, 250, 12), False),           # a width not a multiple of 4
])
def test_kernel_takes_shapes(dims, takes):
    """The route rule, stated without a card: kernel 8's layer count and
    widths."""
    assert kernel_takes(dims) is takes
