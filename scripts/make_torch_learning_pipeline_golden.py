"""Write the golden of the host-side learning pipeline, which the PyTorch
port is held to.

Runs the JAX package on the CPU and stores
``tests/data/go2_learning_pipeline_golden.npz``:

- the JAX ``BatchedPlantCollector`` (``learning/plant_batch.py``) at E=2,
  0.2 s, ``max_iter_first`` 4, commands (0.15, 0, 0) and (0, 0, 0), joint
  noise 0.02, seed 3 (the JAX ``tests/test_plant_batch.py`` settings),
  expert-only (``pb_exp_*``) and combined with the shipped policy
  (``assets/policy_go2_trot_ondevice_dagger.pkl``, ``delay_steps``
  ``PB_DELAY``, ``mpc_min_steps`` ``PB_MIN``, ``pb_comb_*``): every row,
  the survived times, the first two batched plans whole (the cold and the
  first RTI replan: their warm starts, duals, parameters and outputs), for
  every replan the consumed interval of q, v and tau_ff it handed the host
  (``plans_cat``) and the per-env inputs and outputs of its parameter
  assembly (``_batched_params``: the states, the reference xy, the node,
  base_ref and base_ref_e);
- a short ``DataCollection.run`` (Go2 trot at 0.3 m/s, 0.2 s nominal,
  replanning points every 100 steps, one perturbation each, 0.2 s
  perturbed, seed 0): the force draws, the replanning points, each kept
  rollout's rows (``dc_*``);
- a short ``SafeDaggerDataCollection.collect`` (the shipped policy, 0.15
  m/s, 0.2 s, ``delay_steps`` 20, ``mpc_min_steps`` 60, monitor v2): its
  rows, ``is_expert`` labels, the expert ratio and the aggregate's size
  (``sd_*``).

The CPU tests ``tests/test_torch_plant_batch.py`` and
``tests/test_torch_learning_pipeline.py`` read it; no tier-1 test runs a
JAX controller.

    python scripts/make_torch_learning_pipeline_golden.py
"""
import glob
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(ROOT, "tests", "data", "go2_learning_pipeline_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
PB_E, PB_S, PB_NOISE, PB_SEED, PB_ITER_FIRST = 2, 0.2, 0.02, 3, 4
PB_V = ((0.15, 0.0, 0.0), (0.0, 0.0, 0.0))
PB_DELAY, PB_MIN = 20, 60
DC_V, DC_S, DC_GRID = (0.3, 0.0, 0.0), 0.2, 100
SD_V, SD_S, SD_DELAY, SD_MIN = (0.15, 0.0, 0.0), 0.2, 20, 60


def recording_collector(coll, out, prefix):
    """Wrap the collector's batched plan and parameter assembly so that the
    first plan and every replan's parameters are kept under ``prefix``."""
    plan_b, params_fn = coll._plan_b, coll._batched_params
    calls = {"params": [], "cat": []}

    def plan(*a, **k):
        res = plan_b(*a, **k)
        i = len(calls["cat"])
        calls["cat"].append(np.asarray(res[4]))
        if i < 2:
            # the first (cold, max_iter_first) and second (RTI) replans whole
            Xp, Up, lam, lami, shift, params, n_iter = a
            for name, x in (("X_ws", Xp), ("U_ws", Up), ("lam_ws", lam), ("lami_ws", lami),
                            ("x0", params.x0), ("base_ref_in", params.base_ref),
                            ("base_ref_e_in", params.base_ref_e), ("cnt", params.cnt),
                            ("peak", params.peak), ("X", res[0]), ("U", res[1]),
                            ("lam", res[2]), ("lami", res[3]), ("cat", res[4]),
                            ("cost", res[5])):
                out[f"{prefix}plan{i}_{name}"] = np.asarray(x)
            out[f"{prefix}plan{i}_shift"] = np.int64(shift)
            out[f"{prefix}plan{i}_n_iter"] = np.int64(n_iter)
        return res

    def params(sims, ref_xy, v_des, node):
        p = params_fn(sims, ref_xy, v_des, node)
        calls["params"].append((np.stack([np.asarray(s.data.qpos).copy() for s in sims]),
                                np.stack([np.asarray(s.data.qvel).copy() for s in sims]),
                                np.asarray(ref_xy, np.float64).copy(), node,
                                np.asarray(p.base_ref), np.asarray(p.base_ref_e)))
        return p

    coll._plan_b, coll._batched_params = plan, params
    return calls


def collector_runs(out):
    from iterative_learning_nmpc_tpu.learning.network import make_numpy_apply
    from iterative_learning_nmpc_tpu.learning.plant_batch import BatchedPlantCollector
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    coll = BatchedPlantCollector(spec, n_envs=PB_E, delay_steps=PB_DELAY,
                                 mpc_min_steps=PB_MIN)
    coll.mpc.config_opt.max_iter_first = PB_ITER_FIRST
    v = np.asarray(PB_V)
    plan_b, params_fn = coll._plan_b, coll._batched_params
    for prefix, policy in (("pb_exp_", None), ("pb_comb_", ARTIFACT)):
        # one collector for both modes: the jitted plan compiles once
        coll._policy = None if policy is None else make_numpy_apply(policy)
        calls = recording_collector(coll, out, prefix)
        t0 = time.time()
        res = coll.collect(v, sim_time=PB_S, joint_noise=PB_NOISE, seed=PB_SEED)
        print(f"[{prefix}] {len(res.state)} rows, expert ratio {res.expert_ratio:.4f}, fell "
              f"{res.fell.tolist()}, {time.time() - t0:.1f} s", flush=True)
        for k in ("state", "action", "vc_goals", "cc_goals", "time", "env_id", "is_expert",
                  "sim_time", "fell"):
            out[prefix + k] = np.asarray(getattr(res, k))
        out[prefix + "expert_ratio"] = np.float64(res.expert_ratio)
        pq, pv, rxy, node, br, bre = zip(*calls["params"])
        out[prefix + "params_qpos"] = np.stack(pq)
        out[prefix + "params_qvel"] = np.stack(pv)
        out[prefix + "params_ref_xy"] = np.stack(rxy)
        out[prefix + "params_node"] = np.asarray(node)
        out[prefix + "base_ref"] = np.stack(br)
        out[prefix + "base_ref_e"] = np.stack(bre)
        out[prefix + "plans_cat"] = np.stack(calls["cat"])
        coll._plan_b, coll._batched_params = plan_b, params_fn
    out["pb_v_des"] = v
    out["pb_settings"] = np.asarray([PB_E, PB_S, PB_NOISE, PB_SEED, PB_ITER_FIRST, PB_DELAY,
                                     PB_MIN], np.float64)


def datagen_run(out, tmp):
    from iterative_learning_nmpc_tpu.learning import datagen
    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    draws = []
    sample = datagen.sample_force_perturbation

    def recorded(*a, **k):
        fw = sample(*a, **k)
        draws.append(np.concatenate([[fw.start, fw.end], np.asarray(fw.force)]))
        return fw

    datagen.sample_force_perturbation = recorded
    rec = os.path.join(tmp, "dc")
    cfg = datagen.DataCollectionConfig(record_dir=rec, sim_time_nominal=DC_S,
                                       sim_time_perturbed=DC_S, v_des=DC_V,
                                       replan_freq_steps=DC_GRID,
                                       num_perturbations_per_replanning=1, seed=0)
    t0 = time.time()
    dc = datagen.DataCollection(go2_spec(), cfg)
    path = dc.run()
    datagen.sample_force_perturbation = sample
    db = Database(limit=10_000_000, goal_type="vc")
    db.load_saved_database(path)
    nominal = glob.glob(os.path.join(rec, "traj_nominal_*.npz"))[0]
    others = sorted(glob.glob(os.path.join(rec, "traj_[0-9]*.npz")))
    out["dc_draws"] = np.asarray(draws)
    out["dc_points"] = np.asarray(dc.get_replanning_points(nominal))
    out["dc_files"] = np.asarray([os.path.basename(p) for p in others])
    out["dc_rows"] = np.int64(len(db))
    for i, p in enumerate([nominal] + others):
        d = np.load(p)
        for k in ("state", "action", "time", "q", "v"):
            out[f"dc_{i}_{k}"] = d[k]
    print(f"[dc] {len(draws)} draws, points {out['dc_points'].tolist()}, files "
          f"{out['dc_files'].tolist()}, {len(db)} rows, {time.time() - t0:.1f} s", flush=True)


def dagger_run(out, tmp):
    from iterative_learning_nmpc_tpu.learning.dagger import (
        SafeDaggerConfig, SafeDaggerDataCollection)
    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    cfg = SafeDaggerConfig(record_dir=os.path.join(tmp, "sd"), sim_time=SD_S,
                           delay_steps=SD_DELAY, mpc_min_steps=SD_MIN)
    t0 = time.time()
    col = SafeDaggerDataCollection(go2_spec(), cfg)
    agg = col.collect(ARTIFACT, SD_V, None, "goal0_iter0")
    d = np.load(glob.glob(os.path.join(cfg.record_dir, "goal0_iter0", "traj_*.npz"))[0])
    db = Database(limit=10_000_000, goal_type="vc")
    db.load_saved_database(agg)
    for k in ("state", "action", "time", "is_expert", "q", "v"):
        out[f"sd_{k}"] = d[k]
    out["sd_ratio"] = np.float64(col.expert_ratio_history[0])
    out["sd_agg_rows"] = np.int64(len(db))
    print(f"[sd] ratio {col.expert_ratio_history[0]:.4f}, {len(db)} aggregate rows, "
          f"{time.time() - t0:.1f} s", flush=True)


def main():
    out = {}
    t0 = time.time()
    collector_runs(out)
    with tempfile.TemporaryDirectory() as tmp:
        datagen_run(out, tmp)
        dagger_run(out, tmp)
    np.savez(OUT, **out)
    print(f"wrote {OUT} ({len(out)} keys) in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
