"""The port's training side (``learning/network.py``'s training half,
``learning/train.py``) against the JAX package on the CPU: one BatchNorm
training-mode forward and its running statistics against Flax's, the
initial weights' distribution, dropout, ``BehavioralCloning.run`` in both
packages from the same warm-start payload and data, the gate's noisy
leaves against a planted stale-running-mean fault, payloads loaded across
the packages, and the new modules imported without JAX. One JAX
``BehavioralCloning.run`` (its two jitted functions), the Flax net applied
eagerly: ~16 s of worker time.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.learning import network as jnet
from iterative_learning_nmpc_tpu.learning import train as jtrain
from iterative_learning_nmpc_tpu.learning.database import Database as JDatabase
from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy, random_policy_payload
from iterative_learning_nmpc_tpu_torch.learning import network as tnet
from iterative_learning_nmpc_tpu_torch.learning import train as ttrain
from iterative_learning_nmpc_tpu_torch.learning.database import Database as TDatabase

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two fp32 trainers on the same batches agree step for step up to rounding,
# except where training amplifies it:
# - the noisy leaves (``learning.train.noisy_leaves``): a Dense bias that
#   feeds a BatchNorm has a zero gradient (the batch mean removes it) up to
#   rounding noise, which Adam scales to steps of up to ~lr; its running
#   mean follows it. Eval mode reads their difference, so the validation
#   losses and eval outputs carry that noise;
# - an L1 kink (an output within rounding of its target) flips one sign of
#   the gradient, and the steps after it carry the change.
# Measured over eight seeds of this setup (JAX against the port on the CPU,
# one epoch of 16 steps, with and without the OOD mask): train losses
# <= 2.2e-5 relative, validation losses <= 2.1e-4; parameters after the
# first epoch <= 6e-7 without a kink and <= 8.5e-5 with one, the noisy ones
# 2.0e-3 to 3.9e-3 (10x the largest gives NOISY_ATOL; the running means
# kept at momentum 0.99 read 0.61 to 1.0 there); final eval outputs
# <= 1.4e-2 at a scale of ~1.7.
LOSS_RTOL = 1e-4
VAL_RTOL = 1e-3
PARAM_ATOL = 2e-4
NOISY_ATOL = 4e-2
OUT_ATOL = 3e-2


def jax_net(cfg):
    return jnet.GoalConditionedPolicyNet(
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_hidden_layer=cfg["num_hidden_layer"], hidden_dim=cfg["hidden_dim"],
        batch_norm=cfg["batch_norm"], dropout_rate=cfg["dropout_rate"])


def jax_apply(path, x):
    net, variables, _ = jnet.load_policy(path)
    return np.asarray(net.apply(variables, jnp.asarray(x), train=False))


def port_apply(path, x):
    net, _ = tnet.load_policy(path, device="cpu")
    with torch.no_grad():
        return net(torch.as_tensor(x)).numpy()


def test_batchnorm_training_step_matches_flax():
    """A 2 x 64 net with BatchNorm in training mode on one 64-row batch:
    outputs within 1e-5 of Flax's apply(train=True, mutable=batch_stats),
    the updated running means and variances within 1e-6 (the biased batch
    variance; the unbiased one is off by 64/63 of the batch's share)."""
    payload = random_policy_payload(2, 64, seed=3)
    net, _ = policy_from_numpy(payload, device="cpu")
    x = np.random.default_rng(0).normal(0.5, 1.5, (64, 47)).astype(np.float32)
    variables = net.flax_variables()
    out_j, upd = jax_net(net.net_config).apply(variables, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"])
    net.train()
    out_t = net(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=0, atol=1e-5)
    got = net.flax_variables()["batch_stats"]
    for name, stats in upd["batch_stats"].items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[name][k], np.asarray(stats[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{name}.{k}")
    # the unbiased variance would move the running variance past the bound
    h = x @ variables["params"]["Dense_0"]["kernel"] + variables["params"]["Dense_0"]["bias"]
    unbiased = 0.9 * variables["batch_stats"]["BatchNorm_0"]["var"] + 0.1 * h.var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"])).max() > 1e-4


def test_init_distribution_matches_flax():
    """init_network at 47 -> 512 x 3 -> 12: each Dense weight with std
    within 3 % of sqrt(2 / fan_in), as Flax's init draws it (an untruncated
    normal: ~4.6 % of the draws past two standard deviations), zero biases,
    BatchNorm at scale 1, bias 0, mean 0, var 1; one seed gives one net."""
    net = tnet.init_network(47, 12, 3, 512, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    again = tnet.init_network(47, 12, 3, 512, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    _, jvars = jnet.init_network(jax.random.PRNGKey(0), 47, 12, 3, 512)
    assert net.training
    for i, dense in enumerate(net.dense):
        w = dense.weight.detach().numpy()
        want = np.sqrt(2.0 / w.shape[1])
        kj = np.asarray(jvars["params"][f"Dense_{i}"]["kernel"])
        for sample in (w, kj):
            assert abs(sample.std() / want - 1.0) < 0.03, (i, sample.std(), want)
            assert abs((np.abs(sample) > 2 * want).mean() - 0.0455) < 0.01
        assert not dense.bias.detach().any()
        assert torch.equal(dense.weight, again.dense[i].weight)
    for bn in net.norm:
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                    and (bn.running_mean == 0).all() and (bn.running_var == 1).all())


def test_dropout_train_and_eval():
    """Dropout (rate 0.25) between BatchNorm and ReLU: in eval mode the net
    is the same net without dropout; in training mode it zeroes ~25 % of the
    units and scales the kept ones by 4/3 (Flax's rule), reproducibly from
    ``dropout_generator``, and changes the output."""
    payload = random_policy_payload(2, 64, seed=5)
    payload["net_config"]["dropout_rate"] = 0.25
    net, _ = policy_from_numpy(payload, device="cpu")
    plain, _ = policy_from_numpy(random_policy_payload(2, 64, seed=5), device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(256, 47)), dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(net(x), plain(x))
        ones = torch.ones(4096, 64)
        assert torch.equal(net._dropout(ones), ones)
        net.train()
        outs = []
        for _ in range(2):
            net.dropout_generator = torch.Generator().manual_seed(7)
            outs.append(net._dropout(ones))
        assert torch.equal(outs[0], outs[1])
        vals = set(np.unique(outs[0].numpy()).tolist())
        assert vals == {0.0, np.float32(1 / 0.75).item()}
        assert abs(float((outs[0] == 0).float().mean()) - 0.25) < 0.01
        plain.train()
        assert not torch.allclose(net(x), plain(x))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' BehavioralCloning.run from one warm-start payload (a
    seeded 2 x 64 BatchNorm net), on one Database of 1,200 seeded rows with
    an OOD mask and a validation database, batch 64, 3 epochs, lr 1e-3."""
    tmp = tmp_path_factory.mktemp("bc")
    rng = np.random.default_rng(0)
    n = 1200
    states = rng.normal(0.0, 1.0, (n, 44)) * rng.uniform(0.2, 2.0, 44)
    states[:, 0] = rng.uniform(0.0, 1.0, n)
    goals = rng.uniform(-0.3, 0.3, (n, 3))
    actions = np.tanh(states[:, 1:13] * 0.5 + goals[:, :1]) * 0.4
    dbs = {}
    for name, cls in (("jax", JDatabase), ("port", TDatabase)):
        db, val = cls(limit=n), cls(limit=200)
        db.append(states, actions, vc_goals=goals)
        val.append(states[:200] * 1.1, actions[:200], vc_goals=goals[:200])
        dbs[name] = (db, val)
    warm = tnet.save_policy(str(tmp / "warm.pkl"), random_policy_payload(2, 64, seed=11)[
        "variables"], None, dict(input_size=47, output_size=12, num_hidden_layer=2,
                                 hidden_dim=64, batch_norm=True, dropout_rate=0.0))
    ood = rng.uniform(size=n) < 0.2
    runs = {}
    for name, mod in (("jax", jtrain), ("port", ttrain)):
        cfg = mod.TrainConfig(batch_size=64, n_epochs=3, learning_rate=1e-3, ckpt_every=1,
                              save_dir=str(tmp / name), run_name="t", num_hidden_layer=4,
                              hidden_dim=16)       # the warm start's net wins
        bc = mod.BehavioralCloning(cfg) if name == "jax" else mod.BehavioralCloning(cfg, "cpu")
        db, val = dbs[name]
        runs[name] = (bc, bc.run(db, ood_mask=ood, val_database=val, warm_start_path=warm))
    return runs, warm, tmp, dbs["port"] + (ood,)


def payload_variables(path):
    with open(path, "rb") as f:
        return pickle.load(f)["variables"]


def test_bc_run_matches_jax(trained):
    """Per-epoch train losses within LOSS_RTOL of the JAX trainer's,
    validation and OOD validation losses within VAL_RTOL, every parameter
    after the first epoch within PARAM_ATOL (the noisy ones within
    NOISY_ATOL), the trained nets' outputs on 256 fresh inputs within OUT_ATOL,
    the same files (a checkpoint an epoch, the final payload with the
    database's statistics, the metrics), and the warm start's net_config."""
    runs, warm, tmp, _ = trained
    (bj, pj), (bt, pt) = runs["jax"], runs["port"]
    assert [os.path.basename(p) for p in (pj, pt)] == ["policy_t_final.pkl"] * 2
    for name in ("jax", "port"):
        assert sorted(os.listdir(tmp / name)) == [
            "metrics_t.jsonl", "policy_t_ep1.pkl", "policy_t_ep2.pkl", "policy_t_ep3.pkl",
            "policy_t_final.pkl"]
    assert len(bt.metrics) == len(bj.metrics) == 3
    for rt, rj in zip(bt.metrics, bj.metrics):
        assert abs(rt["train_loss"] / rj["train_loss"] - 1.0) <= LOSS_RTOL, (rt, rj)
        for k in ("val_loss", "ood_val_loss"):
            assert abs(rt[k] / rj[k] - 1.0) <= VAL_RTOL, (k, rt, rj)
    assert bt.metrics[-1]["train_loss"] < bt.metrics[0]["train_loss"]
    assert [len(s) for s in bt.step_losses] == [16] * 3     # 1,080 train rows // 64
    payloads = {}
    for name in ("jax", "port"):
        for ep in ("ep1", "final"):
            with open(tmp / name / f"policy_t_{ep}.pkl", "rb") as f:
                payloads[name, ep] = pickle.load(f)
    worst, worst_noisy = ttrain.trained_gaps(payloads["jax", "ep1"]["variables"],
                                             payloads["port", "ep1"]["variables"])
    assert worst <= PARAM_ATOL and worst_noisy <= NOISY_ATOL, (worst, worst_noisy)
    x = np.random.default_rng(9).normal(size=(256, 47)).astype(np.float32)
    np.testing.assert_allclose(port_apply(pt, x), jax_apply(pj, x), rtol=0, atol=OUT_ATOL)
    assert payloads["port", "final"]["net_config"] == payloads["jax", "final"]["net_config"]
    assert payloads["port", "final"]["net_config"]["num_hidden_layer"] == 2
    for u, v in zip(payloads["port", "final"]["norm_policy_input"],
                    payloads["jax", "final"]["norm_policy_input"]):
        np.testing.assert_array_equal(u, v)


def test_noisy_leaf_gate_sees_stale_running_means(trained, monkeypatch):
    """A fault that only the noisy leaves carry, planted in the port: the
    running means kept at momentum 0.99 (Flax's is 0.9). After the first
    epoch every other leaf is as far from the JAX trainer's as without the
    fault, and the noisy ones pass NOISY_ATOL."""
    runs, warm, tmp, (db, val, ood) = trained
    forward = tnet.FlaxBatchNorm.forward

    def stale(bn, x):
        mean = bn.running_mean.clone()
        out = forward(bn, x)
        if bn.training:
            with torch.no_grad():
                bn.running_mean.copy_(0.99 * mean + 0.01 * x.mean(0))
        return out

    monkeypatch.setattr(tnet.FlaxBatchNorm, "forward", stale)
    cfg = ttrain.TrainConfig(batch_size=64, n_epochs=1, learning_rate=1e-3,
                             save_dir=str(tmp / "stale"), run_name="t")
    path = ttrain.BehavioralCloning(cfg, "cpu").run(db, ood_mask=ood, val_database=val,
                                                    warm_start_path=warm)
    va = payload_variables(tmp / "jax" / "policy_t_ep1.pkl")
    good = ttrain.trained_gaps(va, payload_variables(tmp / "port" / "policy_t_ep1.pkl"))
    bad = ttrain.trained_gaps(va, payload_variables(path))
    assert bad[0] == good[0]
    assert good[1] <= NOISY_ATOL < bad[1], (good, bad)


def test_payloads_load_across_packages(trained):
    """Each package's final payload loads in the other and gives that
    package's outputs (1e-6); the port's pickle holds numpy and Python
    objects only (it unpickles with every module but numpy's refused), its
    weights float32; make_numpy_apply matches the JAX one."""
    runs, _, _, _ = trained
    x = np.random.default_rng(10).normal(size=(64, 47)).astype(np.float32)
    for _, path in runs.values():
        np.testing.assert_allclose(port_apply(path, x), jax_apply(path, x), rtol=0, atol=1e-6)
        xs = np.concatenate([x[:, :44], x[:, 44:] * 0.3], 1)
        np.testing.assert_allclose(tnet.make_numpy_apply(path)(xs),
                                   jnet.make_numpy_apply(path)(xs), rtol=0, atol=1e-12)

    class NumpyOnly(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] not in ("numpy", "builtins"):
                raise pickle.UnpicklingError(f"{module}.{name}")
            return super().find_class(module, name)

    with open(runs["port"][1], "rb") as f:
        payload = NumpyOnly(f).load()
    leaves = jax.tree_util.tree_leaves(payload["variables"])
    assert leaves and all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in leaves)


def test_bundle_roundtrip(tmp_path, trained):
    """save_policy_bundle writes the JAX layout: both packages pick the
    member nearest v_des."""
    runs, warm, _, _ = trained
    path = tnet.save_policy_bundle(str(tmp_path / "b.pkl"),
                                   [((0.3, 0, 0), runs["port"][1]), ((0.0, 0, 0), warm)])
    x = np.random.default_rng(2).normal(size=(8, 47)).astype(np.float32)
    for v, member in (((0.25, 0, 0), runs["port"][1]), ((0.05, 0, 0), warm)):
        net_j, vars_j, _ = jnet.load_policy(path, v_des=v)
        with torch.no_grad():
            out = tnet.load_policy(path, v_des=v, device="cpu")[0](torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(out, np.asarray(net_j.apply(vars_j, x, train=False)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out, port_apply(member, x))


def test_new_modules_import_without_jax():
    """learning.train, learning.database and learning.dagger import with
    jax, flax, optax and the JAX package blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'iterative_learning_nmpc_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import iterative_learning_nmpc_tpu_torch.learning.train\n"
            "import iterative_learning_nmpc_tpu_torch.learning.database\n"
            "import iterative_learning_nmpc_tpu_torch.learning.dagger\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
