"""Behavior-cloning data-collection pipelines in the host MuJoCo plant.

Counterpart of ``iterative_learning_nmpc_tpu/learning/datagen.py`` (the
reference's ``Behavior_Cloning/utils/data_collection_force_perturbation.py``):

1. one nominal (unperturbed) expert rollout,
2. replanning points every ``replan_freq_steps`` within one gait period
   (``:201-211``),
3. per replanning point x n_perturbations: restart the sim at the recorded
   state and apply a random base push (50-70 N, 0.2-0.4 s), retrying until
   the rollout survives (``:313-324``),
4. merge all surviving npz rollouts into a Database snapshot + config pickle
   (``:90-112, 253-277``).

Also the omni-directional pretrain collection
(``DAgger/example/data_collection_pretrain_omini_vc_policy_*``): sampled
velocity goals, nominal + perturbed rollouts per goal, OOD side split.

The rollouts are the port's ``rollouts.rollout_mpc`` (``LocomotionMPC``, one
problem a replan, on ``device``: by default the CUDA card), with the same
numpy draws in the same order as the JAX package. The snapshot is written
as ``database_<n>.npz`` (``Database.save_as_npz``), numbered by the
``database_*.npz`` files already in ``record_dir``, where the JAX package
writes ``.hdf5``: the GPU machines the port runs on need not have ``h5py``
(``Database.load`` reads either).
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..mpc.config import GAITS
from ..mpc.controller import SolverDiverged
from ..robots.spec import RobotSpec
from . import rollouts
from .database import Database
from .rollouts import RolloutResult, sample_force_perturbation
from .train import compute_ood_mask


@dataclass
class DataCollectionConfig:
    record_dir: str = "./data"
    sim_time_nominal: float = 2.0
    sim_time_perturbed: float = 1.5
    v_des: Sequence[float] = (0.3, 0.0, 0.0)
    gait_name: str = "trot"
    replan_freq_steps: int = 50          # grid spacing over one gait period
    num_perturbations_per_replanning: int = 10
    max_retries: int = 5
    force_magnitude: Sequence[float] = (50.0, 70.0)
    force_duration: Sequence[float] = (0.2, 0.4)
    database_size: int = 10_000_000
    seed: int = 0


def merge_npz_to_database(paths: Sequence[str], db: Database) -> Database:
    """npz rollouts -> Database rows (reference ``:253-277``)."""
    for traj_id, path in enumerate(paths):
        with np.load(path) as data:
            n = len(data["state"])
            db.append(
                data["state"],
                data["action"],
                vc_goals=data["vc_goals"],
                cc_goals=data["cc_goals"],
                traj_id=np.full(n, traj_id),
                times=data["time"],
            )
    return db


def next_database_path(record_dir: str) -> str:
    """``record_dir/database_<n>.npz``, n the number of snapshots there."""
    existing = glob.glob(os.path.join(record_dir, "database_*.npz"))
    return os.path.join(record_dir, f"database_{len(existing)}.npz")


class DataCollection:
    """Force-perturbation BC dataset generator; the rollouts' controllers
    run on ``device`` (by default the CUDA card)."""

    def __init__(self, spec: RobotSpec, cfg: DataCollectionConfig, device=None):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.rng = np.random.default_rng(cfg.seed)

    # ------------------------------------------------------------------
    def run_unperturbed(self) -> RolloutResult:
        return rollouts.rollout_mpc(
            self.spec,
            sim_time=self.cfg.sim_time_nominal,
            v_des=np.asarray(self.cfg.v_des),
            gait_name=self.cfg.gait_name,
            record_dir=self.cfg.record_dir,
            nominal_flag=True,
            device=self.device,
        )

    def get_replanning_points(self, nominal_path: str) -> List[int]:
        """Step indices of replanning points within one gait period
        (reference ``:201-211``)."""
        with np.load(nominal_path) as data:
            n = len(data["time"])
        period_steps = int(GAITS[self.cfg.gait_name].nominal_period / 1.0e-3)
        return list(range(0, min(period_steps, n), self.cfg.replan_freq_steps))

    def get_reference_state(self, nominal_path: str, step: int):
        with np.load(nominal_path) as data:
            return data["q"][step], data["v"][step], data["time"][step]

    def perturbed_rollout(self, v_des, record_dir: str, q0, v0, t0, rp: int, j: int):
        """One pushed restart from a replanning point of the nominal run."""
        cfg = self.cfg
        fw = sample_force_perturbation(self.rng, 0.0, 0.3, tuple(cfg.force_magnitude),
                                       tuple(cfg.force_duration))
        return rollouts.rollout_mpc(
            self.spec, sim_time=cfg.sim_time_perturbed, v_des=np.asarray(v_des),
            gait_name=cfg.gait_name, record_dir=record_dir, start_state=(q0, v0),
            start_time=float(t0), force_schedule=[fw], nominal_flag=False,
            replanning_point=rp, nth_traj=j, device=self.device)

    # ------------------------------------------------------------------
    def run(self) -> str:
        cfg = self.cfg
        os.makedirs(cfg.record_dir, exist_ok=True)

        nominal = self.run_unperturbed()
        if nominal.early_termination:
            raise RuntimeError("nominal rollout fell — check MPC configuration")
        paths = [nominal.record_path]

        for rp in self.get_replanning_points(nominal.record_path):
            q0, v0, t0 = self.get_reference_state(nominal.record_path, rp)
            for j in range(cfg.num_perturbations_per_replanning):
                for _ in range(cfg.max_retries):
                    out = self.perturbed_rollout(cfg.v_des, cfg.record_dir, q0, v0, t0, rp, j)
                    if not out.early_termination:
                        paths.append(out.record_path)
                        break

        return self.save_training_dataset(paths)

    def save_training_dataset(self, paths: Sequence[str]) -> str:
        db = Database(limit=self.cfg.database_size, goal_type="vc")
        merge_npz_to_database(paths, db)
        return db.save_as_npz(next_database_path(self.cfg.record_dir), config=self.cfg)


@dataclass
class PretrainConfig(DataCollectionConfig):
    """Omni-directional goal sampling (reference goal box ``:168-174``)."""

    n_goals: int = 10
    vx_range: Sequence[float] = (0.0, 0.3)
    vy_range: Sequence[float] = (-0.1, 0.1)
    ood_threshold: float = 4.0


class PretrainDataCollection(DataCollection):
    """Multi-goal dataset generation with an OOD side split."""

    def __init__(self, spec: RobotSpec, cfg: PretrainConfig, device=None):
        super().__init__(spec, cfg, device=device)
        self.cfg: PretrainConfig = cfg

    def sample_goal(self):
        return np.array([
            self.rng.uniform(*self.cfg.vx_range),
            self.rng.uniform(*self.cfg.vy_range),
            0.0,
        ])

    def run(self) -> str:
        cfg = self.cfg
        os.makedirs(cfg.record_dir, exist_ok=True)
        # per-goal groups (nominal_path, member_paths): the OOD mask is
        # defined RELATIVE to each goal's own nominal trajectory
        # (reference ``...pretrain_omini_vc_policy_1direction_perturbed.py:93-127``)
        groups = []
        for g in range(cfg.n_goals):
            goal = self.sample_goal()
            sub = DataCollectionConfig(
                **{k: getattr(cfg, k) for k in DataCollectionConfig.__dataclass_fields__})
            sub.v_des = tuple(goal)
            sub.record_dir = os.path.join(cfg.record_dir, f"goal_{g}")
            dc = DataCollection(self.spec, sub, device=self.device)
            try:
                nominal = dc.run_unperturbed()
            except SolverDiverged:
                # a goal the solver cannot track is skipped; a CUDA, memory
                # or kernel-build error is not a property of the goal
                continue
            if nominal.early_termination:
                continue
            paths = [nominal.record_path]
            pts = dc.get_replanning_points(nominal.record_path)
            for rp in pts[:: max(len(pts) // 2, 1)]:
                q0, v0, t0 = dc.get_reference_state(nominal.record_path, rp)
                for j in range(cfg.num_perturbations_per_replanning):
                    # the goal's rollouts draw from this collection's rng
                    out = self.perturbed_rollout(goal, sub.record_dir, q0, v0, t0, rp, j)
                    if not out.early_termination:
                        paths.append(out.record_path)
            groups.append((nominal.record_path, paths))
        return self.save_training_dataset_with_ood(groups)

    def save_training_dataset_with_ood(self, groups) -> str:
        """Merge per-goal rollouts into one snapshot with the per-row OOD
        flag stored alongside (L2 vs the goal's time-aligned nominal >
        ood_threshold); ``examples/train_bc.py`` reads it back and feeds
        the x5 weighted sampler."""
        db = Database(limit=self.cfg.database_size, goal_type="vc")
        traj_id = 0
        for nominal_path, paths in groups:
            with np.load(nominal_path) as nom:
                nom_states, nom_times = nom["state"], nom["time"]
            for path in paths:
                with np.load(path) as data:
                    n = len(data["state"])
                    mask = compute_ood_mask(
                        data["state"], nom_states, data["time"], nom_times,
                        threshold=self.cfg.ood_threshold,
                    )
                    db.append(
                        data["state"], data["action"],
                        vc_goals=data["vc_goals"], cc_goals=data["cc_goals"],
                        traj_id=np.full(n, traj_id), times=data["time"],
                        ood=mask,
                    )
                traj_id += 1
        return db.save_as_npz(next_database_path(self.cfg.record_dir), config=self.cfg)
