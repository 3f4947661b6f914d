"""The port's ``parallel/`` (``mesh`` on ``torch.distributed``, ``launcher``)
on the CPU under gloo: two worker processes (``torch_parallel_worker.py``,
no JAX) join through ``launch_distributed`` and run a psum,
``all_gather_dataset``, ``expert_ratio_psum``, a dp-sharded
``make_batch_solver`` solve against the unsharded one, and one
``make_train_step_dp`` step held to the JAX package's ``make_train_step_dp``
on a 2-device slice of the conftest's CPU mesh, with the same weights and
batch. A rank whose peer never comes raises within its timeout. The
placement rules (``shard_by_batch``, ``shard_batch``) on one process. 20 s
of worker time: the JAX step 5 s and the two ranks side by side 8 s (the
first test, 13 s), the lone rank 6 s (its timeout 2 s), placement <1 s.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from iterative_learning_nmpc_tpu.learning.network import init_network
from iterative_learning_nmpc_tpu.parallel import mesh as jmesh
from iterative_learning_nmpc_tpu_torch.learning.network import _numpy_tree
from iterative_learning_nmpc_tpu_torch.learning.randomize import (
    randomize_payload, randomize_terrain)
from iterative_learning_nmpc_tpu_torch.learning.train import trained_gaps
from iterative_learning_nmpc_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_by_batch
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
LR, RENDEZVOUS_S, RUN_S = 1e-3, 20.0, 120.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(args_by_rank, timeout):
    """Start every worker, wait for all of them with one deadline; kill
    them all on a timeout. Returns [(returncode, log)]."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, *map(str, a)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for a in args_by_rank]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, log.decode(errors="replace")))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a worker hung (rendezvous or collective)")
    return out


@pytest.fixture(scope="module")
def jax_step():
    """The JAX dp train step on a 2-device mesh: a 47 -> 64x2 -> 12 net
    with BatchNorm, Adam at LR, a 16-row batch (8 a device)."""
    net, variables = init_network(jax.random.PRNGKey(0), 47, 12, num_hidden_layer=2,
                                  hidden_dim=64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 47)).astype(np.float32)
    y = rng.standard_normal((16, 12)).astype(np.float32)
    mesh = jmesh.make_mesh(2)
    tx = optax.adam(LR)
    step = jmesh.make_train_step_dp(net, tx, mesh)
    dp = NamedSharding(mesh, P("dp"))
    params, stats, _, loss = step(variables["params"], variables["batch_stats"],
                                  tx.init(variables["params"]),
                                  jax.device_put(jnp.asarray(x), dp),
                                  jax.device_put(jnp.asarray(y), dp))
    payload = {"variables": _numpy_tree(variables, np.float32), "norm_policy_input": None,
               "net_config": dict(input_size=47, output_size=12, num_hidden_layer=2,
                                  hidden_dim=64, batch_norm=True, dropout_rate=0.0)}
    after = _numpy_tree({"params": params, "batch_stats": stats}, np.float32)
    return dict(payload=payload, x=x, y=y, lr=LR), after, float(loss)


def test_two_ranks_under_gloo(tmp_path, jax_step):
    case, after_jax, loss_jax = jax_step
    with open(tmp_path / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    coordinator = f"127.0.0.1:{free_port()}"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(2)]
    logs = run_workers([(coordinator, 2, r, tmp_path / "case.pkl", outs[r], RENDEZVOUS_S)
                        for r in range(2)], RUN_S)
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
    for r, rr in enumerate(res):
        assert (rr["rank"], rr["size"], rr["backend"]) == (r, 2, "gloo")
        assert rr["psum"] == 28.0                        # sum(arange(8))
        np.testing.assert_array_equal(rr["gathered"], np.arange(32.0).reshape(16, 2))
        assert rr["ratio"] == 0.25
        assert rr["solve_rows"] == 2
        # the sharded solve of 2 problems against the unsharded one of 4
        # (JAX tests/test_parallel.py's standard for its own): measured 0
        assert rr["max_dx"] <= 1e-4, rr["max_dx"]
        # the loss: both average the shards' L1 losses (fp32 sums in another
        # order), measured 0 of 1.006
        assert abs(rr["loss"] - loss_jax) <= 1e-6 * abs(loss_jax), (rr["loss"], loss_jax)
        # the running statistics: 0.9 old + 0.1 the shards' mean batch
        # statistics (JAX pmean): measured 1.2e-7
        for layer, st in after_jax["batch_stats"].items():
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(rr["variables"]["batch_stats"][layer][leaf],
                                           st[leaf], rtol=0, atol=1e-6, err_msg=f"{layer} {leaf}")
        # the parameters after one Adam step on the averaged gradients: the
        # step is lr * g / (|g| + eps), so a gradient of rounding noise (the
        # Dense biases feeding a BatchNorm, learning.train.noisy_leaves) may
        # move by up to lr either way (measured 4.8e-4); every other leaf:
        # measured 1.2e-7
        worst, worst_noisy = trained_gaps(after_jax, rr["variables"])
        assert worst <= 1e-5 and worst_noisy <= 2.0 * LR, (worst, worst_noisy)
    # both ranks hold the same replicated weights
    assert trained_gaps(res[0]["variables"], res[1]["variables"]) == (0.0, 0.0)


def test_lone_rank_raises_within_its_timeout(tmp_path):
    """Rank 0 of 2 whose peer never comes: the rendezvous raises after its
    timeout; no process carries on alone."""
    t0 = time.monotonic()
    (rc, log), = run_workers([(f"127.0.0.1:{free_port()}", 2, 0, "-", tmp_path / "x.pkl", 2.0)],
                             60.0)
    assert rc != 0 and "Timed out" in log, log[-2000:]
    assert "[worker" not in log
    assert time.monotonic() - t0 < 45.0


def test_shard_by_batch_placement():
    """Rank 1 of 2 (no process group needed to place): a payload spec
    marked True slices its mass and com and keeps its constants whole;
    shape inference slices every leaf whose
    leading dim is the batch, a spec's (18, 3) joint_pos at batch 18 too
    (the documented pitfall of inference)."""
    mesh = Mesh(1, 2, torch.device("cpu"))
    spec = go2_spec(device="cpu")
    ps = randomize_payload(spec, torch.Generator().manual_seed(0), 18)
    tr = randomize_terrain(torch.Generator().manual_seed(1), 18, device="cpu")
    x0, w = np.arange(18 * 36.0).reshape(18, 36), torch.ones(18, 47)
    x, p, t, ww = shard_by_batch(mesh, (x0, ps, tr, w), 18, batched=(True, True, True, False))
    assert torch.equal(x, torch.as_tensor(x0[9:]))
    assert torch.equal(p.mass, ps.mass[9:]) and torch.equal(p.com, ps.com[9:])
    assert p.joint_pos is spec.joint_pos and p.name == "go2"
    assert torch.equal(t.contact.stiffness, tr.contact.stiffness[9:])
    assert ww.shape == (18, 47)
    _, p, _, ww = shard_by_batch(mesh, (x0, ps, tr, w), 18)
    assert p.mass.shape == (9, 18) and p.joint_pos.shape == (9, 3) and ww.shape == (9, 47)
    x, p = shard_batch(mesh, (torch.zeros(4, 3), ps))
    assert x.shape == (2, 3) and p.mass.shape == (9, 18) and p.joint_pos.shape == (18, 3)

