"""LocoSafeDAgger on the device: collect -> relabel -> aggregate -> retrain
-> serve, with the data step a batch of on-device combined-controller
rollouts.

Counterpart of ``OnDeviceSafeDagger`` in
``iterative_learning_nmpc_tpu/learning/dagger.py``. One
``ondevice.make_batched_mpc_rollout`` in SafeDAgger mode serves every
iteration; each iteration's retrained weights and normalisation statistics
enter it through ``policy_update``. A data step keeps the rows where the
environment was valid and the expert in control, aggregates them with the
previous dataset and writes the snapshot; training warm-starts from the
current policy (``train.BehavioralCloning``, on the same device).

The aggregate is written as ``agg_dataset.npz`` (``database.Database``'s
npz snapshot), where the JAX package writes ``agg_dataset.hdf5``: the GPU
machines the port runs on need not have ``h5py``. An ``initial_dataset``
is read by its suffix (.hdf5 or .npz).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.dynamics import settled_state
from ..robots.spec import RobotSpec
from . import ondevice
from .database import Database
from .network import load_policy
from .train import BehavioralCloning, TrainConfig


@dataclass
class SafeDaggerConfig:
    record_dir: str = "./dagger"
    sim_time: float = 10.0
    gait_name: str = "trot"
    database_size: int = 10_000_000
    n_epochs: int = 15
    learning_rate: float = 1.0e-3
    batch_size: int = 256
    monitor: str = "v2"
    delay_steps: int = 100
    mpc_min_steps: int = 2500
    goals: Sequence[Sequence[float]] = ((0.15, 0.0, 0.0), (0.0, 0.0, 0.0), (-0.15, 0.0, 0.0))
    n_iterations_per_goal: int = 4
    seed: int = 0
    # initial-state base randomisation (z offset, pitch and roll, base
    # linear velocity noise stds): the expert then demonstrates recovery
    # from height droop and tilt
    x0_z_noise: float = 0.0
    x0_rpy_noise: float = 0.0
    x0_vel_noise: float = 0.0
    # an optional tighter monitor height band for drift-triggered relabeling
    unsafe_height_bounds: Optional[Sequence[float]] = None


class OnDeviceSafeDagger:
    """The SafeDAgger outer loop with ``batch`` parallel on-device rollouts
    per data step, on ``device`` (by default the CUDA card). The JAX
    package's domain-randomisation arguments (``randomize``,
    ``payload_kwargs``, ``terrain_kwargs``) come with per-environment
    payload randomisation (``randomize_payload``), which is not ported."""

    def __init__(self, spec: RobotSpec, cfg: SafeDaggerConfig, initial_policy: str,
                 initial_dataset: Optional[str] = None, batch: int = 32,
                 joint_noise: float = 0.03, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.joint_noise = joint_noise
        self.policy_path = initial_policy
        self.dataset_path = initial_dataset
        self.expert_ratio_history: List[float] = []

        # one rollout for every iteration (dt_nodes = 40 ms)
        self.n_intervals = max(1, int(round(cfg.sim_time / 0.04)))
        self.rollout = ondevice.make_batched_mpc_rollout(
            spec, gait_name=cfg.gait_name, n_intervals=self.n_intervals,
            policy=load_policy(initial_policy, device=self.device),
            delay_steps=cfg.delay_steps, mpc_min_steps=cfg.mpc_min_steps,
            unsafe_height_bounds=(tuple(cfg.unsafe_height_bounds)
                                  if cfg.unsafe_height_bounds else None),
            device=self.device)
        self._x0 = settled_state(spec)
        self._rng = np.random.default_rng(cfg.seed)

    def _load_update(self, path: str):
        """(net, norm) of a payload, for ``policy_update``."""
        return load_policy(path, device=self.device)

    def _database(self, path: Optional[str]) -> Database:
        db = Database(limit=self.cfg.database_size, goal_type="vc")
        if path is not None and os.path.exists(path):
            db.load(path)
        return db

    def collect(self, policy_path: str, v_des, prev_dataset: Optional[str],
                tag: str) -> Optional[str]:
        """One data step: B combined-controller rollouts, the expert rows
        kept and aggregated with ``prev_dataset`` into
        ``record_dir/tag/agg_dataset.npz``; with no row at all, the previous
        dataset."""
        cfg, B, dev = self.cfg, self.batch, self.device
        out_dir = os.path.join(cfg.record_dir, tag)
        os.makedirs(out_dir, exist_ok=True)

        x0b = np.tile(self._x0[None], (B, 1))
        x0b[:, 6:18] += self._rng.normal(0, self.joint_noise, (B, 12)).astype(np.float32)
        # base-state randomisation (chart layout: z at 2, [yaw, pitch, roll]
        # at 3:6, base velocity at 18:21)
        if cfg.x0_z_noise > 0:
            x0b[:, 2] += np.clip(self._rng.normal(0, cfg.x0_z_noise, B),
                                 -2.5 * cfg.x0_z_noise, 2.5 * cfg.x0_z_noise).astype(np.float32)
        if cfg.x0_rpy_noise > 0:
            x0b[:, 4:6] += self._rng.normal(0, cfg.x0_rpy_noise, (B, 2)).astype(np.float32)
        if cfg.x0_vel_noise > 0:
            x0b[:, 18:21] += self._rng.normal(0, cfg.x0_vel_noise, (B, 3)).astype(np.float32)
        vdes = np.tile(np.asarray(v_des, np.float32)[None], (B, 1))

        out = self.rollout(torch.as_tensor(x0b, device=dev), torch.as_tensor(vdes, device=dev),
                           policy_update=self._load_update(policy_path))
        T = out.state44.shape[1]
        keep_d = (out.valid > 0.5) & (out.is_expert > 0.5)
        n_steps = int(out.valid.sum())
        keep = keep_d.cpu().numpy()
        ratio = float(keep.sum() / max(n_steps, 1))
        self.expert_ratio_history.append(ratio)
        print(f"[dagger] {tag}: expert-influence ratio {ratio:.3f} "
              f"({int(keep.sum())}/{n_steps} valid steps, {B} envs)")

        db = self._database(prev_dataset)
        if keep.any():
            flat, flat_d = keep.reshape(-1), keep_d.reshape(-1)
            states = out.state44.reshape(-1, 44)[flat_d].cpu().numpy()
            actions = out.action.reshape(-1, 12)[flat_d].cpu().numpy()
            goals = np.repeat(vdes, T, axis=0)[flat]
            times = np.tile(np.arange(T) * 1e-3, B)[flat]
            ids = np.repeat(np.arange(B), T)[flat] + 1000 * len(self.expert_ratio_history)
            db.append(states, actions, vc_goals=goals, traj_id=ids, times=times)
        if len(db) == 0:
            # every env fell during the delay and nothing was relabeled: the
            # training step keeps the previous dataset
            print(f"[dagger] {tag}: no expert rows collected")
            return prev_dataset
        return db.save_as_npz(os.path.join(out_dir, "agg_dataset.npz"), config=cfg)

    def run_training(self, dataset_path: str, tag: str) -> str:
        """Warm-started training on the aggregate; below ``batch_size`` rows
        the current policy stays."""
        cfg = self.cfg
        db = self._database(dataset_path)
        if len(db) < cfg.batch_size:
            print(f"[dagger] {tag}: dataset too small ({len(db)}), skip training")
            return self.policy_path
        tc = TrainConfig(learning_rate=cfg.learning_rate, batch_size=cfg.batch_size,
                         n_epochs=cfg.n_epochs, save_dir=os.path.join(cfg.record_dir, "policies"),
                         run_name=tag, seed=cfg.seed)
        return BehavioralCloning(tc, device=self.device).run(db, warm_start_path=self.policy_path)

    def run(self) -> str:
        """(collect -> train) x n_iterations per goal; returns the final
        policy's path."""
        for gi, goal in enumerate(self.cfg.goals):
            for it in range(self.cfg.n_iterations_per_goal):
                tag = f"goal{gi}_iter{it}"
                self.dataset_path = self.collect(self.policy_path, goal, self.dataset_path, tag)
                if self.dataset_path is not None:
                    self.policy_path = self.run_training(self.dataset_path, tag)
        return self.policy_path
