"""The replay buffer of the learning loop: a numpy copy of
``iterative_learning_nmpc_tpu/learning/database.py``.

A ring buffer of (state, action, vc_goal, cc_goal, traj_id, traj_time, ood)
rows with ``limit`` and overflow wrap-around; the input statistics skip
column 0 of the states (the gait phase), and vc goals pass through (mean 0,
std 1). Snapshots come in two formats:

- HDF5 (``save_as_hdf5`` / ``load_saved_database``), in the JAX package's
  group layout; ``h5py`` is imported inside those two methods only.
- npz (``save_as_npz`` / ``load_from_npz``), with the JAX package's keys
  (``states``, ``vc_goals``, ``cc_goals`` (``zeros(0)`` when absent),
  ``actions``) plus ``traj_ids``, ``traj_times`` and ``ood``. The JAX
  ``Database.load_from_npz`` reads such a file, since it checks only the
  first four keys.

The GPU machines the port runs on need not have ``h5py``, so the port's
``dagger.OnDeviceSafeDagger`` writes its aggregate as ``agg_dataset.npz``
in every environment, where the JAX package writes ``agg_dataset.hdf5``;
``Database.load`` reads either by its suffix.

This module imports neither torch nor JAX.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


class Database:
    GROUPS = ("states", "vc_goals", "cc_goals", "actions")

    def __init__(self, limit: int, norm_input: bool = True, goal_type: str = "vc"):
        if goal_type not in ("vc", "cc"):
            raise ValueError("Goal type can only be vc or cc")
        self.limit = int(limit)
        self.length = 0
        self.start = 0
        self.goal_type = goal_type
        self.norm_input = norm_input

        self.states: Optional[np.ndarray] = None
        self.actions: Optional[np.ndarray] = None
        self.vc_goals: Optional[np.ndarray] = None
        self.cc_goals: Optional[np.ndarray] = None
        self.traj_ids: Optional[np.ndarray] = None
        self.traj_times: Optional[np.ndarray] = None
        # per-row out-of-distribution flag (the x5 sampling input)
        self.ood: Optional[np.ndarray] = None

        self.states_mean = None
        self.states_std = None
        self.vc_goals_mean = 0.0
        self.vc_goals_std = 1.0
        self.cc_goals_mean = None
        self.cc_goals_std = None
        self._stats_dirty = True

    def __len__(self):
        return self.length

    def _order(self):
        """The ring buffer's rows in logical order."""
        return (self.start + np.arange(self.length)) % self.limit

    def _alloc(self, states, actions, vc_goals, cc_goals):
        def buf(sample):
            width = np.shape(sample)[-1] if sample is not None else None
            return np.zeros((self.limit, width), dtype=np.float64) if width else None

        self.states = buf(states)
        self.actions = buf(actions)
        self.vc_goals = buf(vc_goals)
        self.cc_goals = buf(cc_goals)
        self.traj_ids = np.zeros(self.limit, dtype=np.int64)
        self.traj_times = np.zeros(self.limit, dtype=np.float64)
        self.ood = np.zeros(self.limit, dtype=np.bool_)

    def append(self, states, actions, vc_goals=None, cc_goals=None, traj_id=None, times=None,
               ood=None):
        if vc_goals is None and cc_goals is None:
            raise ValueError("both vc_goals and cc_goals cant be empty!")
        states = np.atleast_2d(np.asarray(states))
        actions = np.atleast_2d(np.asarray(actions))
        n = len(states)
        if self.states is None:
            self._alloc(states[0], actions[0],
                        None if vc_goals is None else np.atleast_2d(vc_goals)[0],
                        None if cc_goals is None else np.atleast_2d(cc_goals)[0])

        idx = (self.start + self.length + np.arange(n)) % self.limit
        overflow = self.length + n - self.limit
        if overflow > 0:
            self.start = (self.start + overflow) % self.limit
            self.length = self.limit
        else:
            self.length += n

        self.states[idx] = states
        self.actions[idx] = actions
        if vc_goals is not None:
            self.vc_goals[idx] = np.atleast_2d(np.asarray(vc_goals))
        if cc_goals is not None and self.cc_goals is not None:
            self.cc_goals[idx] = np.atleast_2d(np.asarray(cc_goals))
        if traj_id is not None:
            self.traj_ids[idx] = np.asarray(traj_id)
        if times is not None:
            self.traj_times[idx] = np.asarray(times)
        if ood is not None:
            self.ood[idx] = np.asarray(ood, dtype=bool)
        # statistics are recomputed on first use: a rescan per append would
        # make DAgger's aggregation quadratic
        self._stats_dirty = True

    def _ensure_stats(self):
        if self._stats_dirty:
            self.calc_input_mean_std()

    def calc_input_mean_std(self):
        """Per-column mean and std of the states (column 0, the gait phase,
        is left unnormalised by ``normalize_states``) and of the cc goals."""
        s = self.states_array()
        self.states_mean = s.mean(axis=0)
        self.states_std = s.std(axis=0)
        if self.cc_goals is not None and self.length:
            cc = self.cc_goals[self._order()]
            self.cc_goals_mean = cc.mean(axis=0)
            self.cc_goals_std = cc.std(axis=0)
        self._stats_dirty = False

    def normalize_states(self, states: np.ndarray) -> np.ndarray:
        self._ensure_stats()
        out = np.array(states, dtype=np.float64, copy=True)
        std = np.where(self.states_std[1:] > 1e-8, self.states_std[1:], 1.0)
        out[..., 1:] = (out[..., 1:] - self.states_mean[1:]) / std
        return out

    def states_array(self):
        return self.states[self._order()] if self.length else np.zeros((0, 1))

    def actions_array(self):
        return self.actions[self._order()]

    def ood_array(self):
        """Per-row OOD flags in logical order (all False when never set)."""
        if self.length == 0 or self.ood is None:
            return np.zeros(0, dtype=bool)
        return self.ood[self._order()]

    def goals_array(self):
        if self.goal_type == "vc":
            return self.vc_goals[self._order()]
        return self.cc_goals[self._order()]

    def __getitem__(self, index):
        """(x = [state || goal], y = action), normalised as configured."""
        self._ensure_stats()
        i = self._order()[index]
        state = self.states[i]
        if self.norm_input:
            state = self.normalize_states(state)
        if self.goal_type == "vc":
            goal = self.vc_goals[i]
            if self.norm_input:
                goal = (goal - self.vc_goals_mean) / self.vc_goals_std
        else:
            goal = self.cc_goals[i]
            if self.norm_input:
                std = np.where(self.cc_goals_std > 1e-8, self.cc_goals_std, 1.0)
                goal = (goal - self.cc_goals_mean) / std
        return np.concatenate([state, goal], axis=-1), self.actions[i]

    def training_arrays(self):
        """The whole (X, Y) as float32, for the trainer."""
        states = self.states_array()
        if self.norm_input:
            states = self.normalize_states(states)
        goals = self.goals_array()
        if self.goal_type == "vc" and self.norm_input:
            goals = (goals - self.vc_goals_mean) / self.vc_goals_std
        X = np.concatenate([states, goals], axis=-1)
        return X.astype(np.float32), self.actions_array().astype(np.float32)

    def get_database_mean_std(self):
        if not self.norm_input:
            return None
        self._ensure_stats()
        if self.goal_type == "vc":
            return [self.states_mean, self.states_std, self.vc_goals_mean, self.vc_goals_std]
        return [self.states_mean, self.states_std, self.cc_goals_mean, self.cc_goals_std]

    # ---- snapshots ----
    @staticmethod
    def _save_config(filename: str, config) -> None:
        if config is not None:
            with open(os.path.splitext(filename)[0] + "_config.pkl", "wb") as f:
                pickle.dump(config, f)

    def save_as_hdf5(self, filename: str, config=None):
        import h5py

        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        order = self._order()
        with h5py.File(filename, "w") as hf:
            hf.create_dataset("states", data=self.states[order])
            hf.create_dataset("actions", data=self.actions[order])
            if self.vc_goals is not None:
                hf.create_dataset("vc_goals", data=self.vc_goals[order])
            if self.cc_goals is not None:
                hf.create_dataset("cc_goals", data=self.cc_goals[order])
            hf.create_dataset("traj_ids", data=self.traj_ids[order])
            hf.create_dataset("traj_times", data=self.traj_times[order])
            hf.create_dataset("ood", data=self.ood[order])
        self._save_config(filename, config)
        return filename

    def load_saved_database(self, filename: str):
        import h5py

        with h5py.File(filename, "r") as hf:
            states = hf["states"][:]
            actions = hf["actions"][:]
            vc_goals = hf["vc_goals"][:] if "vc_goals" in hf else None
            cc_goals = hf["cc_goals"][:] if "cc_goals" in hf else None
            traj_ids = hf["traj_ids"][:] if "traj_ids" in hf else None
            traj_times = hf["traj_times"][:] if "traj_times" in hf else None
            ood = hf["ood"][:] if "ood" in hf else None
        self.append(states, actions, vc_goals=vc_goals, cc_goals=cc_goals,
                    traj_id=traj_ids, times=traj_times, ood=ood)

    def save_as_npz(self, filename: str, config=None):
        """The JAX package's npz keys plus traj_ids, traj_times and ood; with
        ``config``, its pickle beside the file as ``save_as_hdf5`` writes it."""
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        order = self._order()
        np.savez(
            filename,
            states=self.states[order],
            vc_goals=self.vc_goals[order] if self.vc_goals is not None else np.zeros(0),
            cc_goals=self.cc_goals[order] if self.cc_goals is not None else np.zeros(0),
            actions=self.actions[order],
            traj_ids=self.traj_ids[order],
            traj_times=self.traj_times[order],
            ood=self.ood[order],
        )
        self._save_config(filename, config)
        return filename

    def load_from_npz(self, filename: str):
        with np.load(filename) as data:
            for f in self.GROUPS:
                if f not in data:
                    raise ValueError(f"Missing field '{f}' in NPZ file.")
            extra = {k: data[k] if k in data else None
                     for k in ("traj_ids", "traj_times", "ood")}
            self.append(
                data["states"], data["actions"],
                vc_goals=data["vc_goals"] if data["vc_goals"].size else None,
                cc_goals=data["cc_goals"] if data["cc_goals"].size else None,
                traj_id=extra["traj_ids"], times=extra["traj_times"], ood=extra["ood"])

    def load(self, filename: str):
        """Append a snapshot, read by its suffix: ``.hdf5`` / ``.h5`` through
        h5py, ``.npz`` through numpy."""
        ext = os.path.splitext(filename)[1].lower()
        if ext in (".hdf5", ".h5"):
            return self.load_saved_database(filename)
        if ext == ".npz":
            return self.load_from_npz(filename)
        raise ValueError(f"unknown dataset format {ext!r} ({filename}): expected .hdf5 or .npz")
