"""Gait machines and footstep planners (numpy host API; the cyclic
windows also on a device, ``GaitPlanner.window_device``).

Counterpart of ``iterative_learning_nmpc_tpu/gait/planner.py``; the same
rules in float64 numpy, so both packages plan identical contact schedules
and footsteps:

- ``GaitPlanner`` / ``ContactPlanner``: periodic per-foot contact bitmaps
  from phase offsets and stance ratios, windowed over the horizon.
- ``RaibertContactPlanner``: footsteps at the hip offset plus a velocity
  feed-forward, a 0.1 (v_des - v) feedback and a capture-point angular term.
- ``CustomContactPlanner`` / ``AcyclicContactPlanner``: user-supplied plans.
"""
from __future__ import annotations

from math import ceil
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..mpc.config import GaitConfig


class GaitPlanner:
    """Periodic contact bitmap machine."""

    def __init__(self, feet_frame_names: Sequence[str], dt_nodes: float,
                 config_gait: GaitConfig):
        self.feet_frame_names = list(feet_frame_names)
        self.n_foot = len(self.feet_frame_names)
        self.dt_nodes = dt_nodes
        self.config_gait = config_gait
        self.nodes_per_cycle = round(config_gait.nominal_period / dt_nodes)

        n = self.nodes_per_cycle
        seq = np.zeros((self.n_foot, n), dtype=np.int32)
        switch = np.zeros((self.n_foot, n), dtype=np.int32)
        for i_foot in range(self.n_foot):
            mk = float(config_gait.phase_offset[i_foot])
            bk = round((mk + float(config_gait.stance_ratio[i_foot])) % 1.0, 2)
            s, e = ceil(mk * n), ceil(bk * n)
            if mk < bk:
                seq[i_foot, s:e] = 1
            else:
                seq[i_foot, s:] = 1
                seq[i_foot, :e] = 1
            switch[i_foot, s % n] = 1
            switch[i_foot, e % n] = -1
        self.gait_sequence = seq
        self.switch_cnt = switch
        self.peak_swing = 1 - seq

    def _window(self, table: np.ndarray, i_node: int, n_nodes: int) -> np.ndarray:
        i_cycle = i_node % self.nodes_per_cycle
        n_rep = n_nodes // self.nodes_per_cycle + 2
        ext = np.tile(table, (1, n_rep))
        return ext[:, i_cycle: i_cycle + n_nodes]

    def get_contacts(self, i_node: int, n_nodes: int) -> np.ndarray:
        return self._window(self.gait_sequence, i_node, n_nodes)

    def get_peaks(self, i_node: int, n_nodes: int) -> np.ndarray:
        return self._window(self.peak_swing, i_node, n_nodes)

    def get_make_break_contacts(self, i_node: int, n_nodes: int):
        """(make, break) windows: 1 where a foot's contact starts, ends."""
        mk = np.where(self.switch_cnt == 1, 1, 0)
        bk = np.where(self.switch_cnt == -1, 1, 0)
        return self._window(mk, i_node, n_nodes), self._window(bk, i_node, n_nodes)

    def window_device(self, i_node, n_nodes: int, device=None):
        """(contacts, peaks) (n_foot, n_nodes) int32 tensors on the device of
        ``i_node``, a start node given as a tensor (an int goes to ``device``,
        by default the CUDA card): the windows of get_contacts / get_peaks,
        with no copy back to the host."""
        if not isinstance(i_node, torch.Tensor):
            i_node = torch.as_tensor(i_node, device=resolve_device(device))
        dev = i_node.device
        idx = torch.remainder(i_node + torch.arange(n_nodes, device=dev),
                              self.nodes_per_cycle)
        return (torch.as_tensor(self.gait_sequence, device=dev)[:, idx],
                torch.as_tensor(self.peak_swing, device=dev)[:, idx])


class ContactPlanner(GaitPlanner):
    """Cyclic gait, no location restriction."""

    def get_locations(self, i_node: int, n_nodes: int) -> Optional[np.ndarray]:
        return None


class RaibertContactPlanner(ContactPlanner):
    """Raibert-heuristic footstep placement. The state is set with
    ``set_state`` (base position, world velocity, the chart's [yaw, pitch,
    roll], the CoM, the command) before ``get_locations``; with
    ``cache_cnt`` a footstep planned for an absolute node is kept until
    ``remove_cnt_before`` drops it."""

    GRAVITY = 9.81

    def __init__(self, feet_frame_names, dt_nodes, config_gait, offset_hip_b: np.ndarray,
                 x_offset: float = 0.0, y_offset: float = 0.0, foot_size: float = 0.0,
                 height_offset: float = 0.0, cache_cnt: bool = True):
        super().__init__(feet_frame_names, dt_nodes, config_gait)
        self.foot_size = foot_size
        self.cache_cnt = cache_cnt
        self.height_offset = height_offset
        self.offset_hip_b = np.array(offset_hip_b, dtype=np.float64)
        if self.n_foot == 4:
            self.offset_hip_b[:, 0] += np.array([x_offset, x_offset, -x_offset, -x_offset])
            self.offset_hip_b[:, 1] += np.array([y_offset, -y_offset, y_offset, -y_offset])
        self.planned_cnt = {i: {} for i in range(self.n_foot)}
        self._state = None

    def set_state(self, pos, v_w, ypr, com_xyz, v_des=np.zeros(3), w_yaw=0.0):
        self._state = (
            np.asarray(pos, dtype=np.float64),
            np.asarray(v_w, dtype=np.float64),
            np.asarray(ypr, dtype=np.float64),
            np.asarray(com_xyz, dtype=np.float64),
            np.asarray(v_des, dtype=np.float64),
            float(w_yaw),
        )

    def remove_cnt_before(self, i_node: int):
        self.planned_cnt = {
            i: {n: p for n, p in d.items() if n >= i_node}
            for i, d in self.planned_cnt.items()
        }

    def get_locations(self, i_node: int, n_nodes: int) -> np.ndarray:
        """(n_foot, n_nodes, 3) footsteps: from each make-contact node of the
        window on, the planned location; zeros before a foot's first one."""
        if self._state is None:
            raise RuntimeError("call set_state() before get_locations()")
        pos, v_w, ypr, com_xyz, v_des, w_yaw = self._state
        locations = np.zeros((self.n_foot, n_nodes, 3))
        mk, _ = self.get_make_break_contacts(i_node, n_nodes)

        com_xy, com_z = com_xyz[:2], com_xyz[2] - self.height_offset
        vtrack = v_des[:2]
        yaw = ypr[0]
        R_yaw = np.array(
            [[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]]
        )
        for i_foot, i_mk in np.argwhere(mk == 1):
            abs_node = i_node + i_mk
            if self.cache_cnt:
                cached = self.planned_cnt[i_foot].get(abs_node)
                if cached is not None:
                    locations[i_foot, i_mk:] = cached
                    continue
            time_to_cnt = round(i_mk * self.dt_nodes, 3)
            stance_ratio = float(self.config_gait.stance_ratio[i_foot])
            t_stance = self.config_gait.nominal_period * stance_ratio
            hip_loc = (
                com_xy
                + (R_yaw @ self.offset_hip_b[i_foot])[:2]
                + vtrack * time_to_cnt * (1 + stance_ratio)
            )
            step_adjustment = 0.1 * (vtrack - v_w[:2])
            raibert_step = 0.5 * vtrack * t_stance
            ang = np.cross(
                0.5 * np.sqrt(max(com_z, 1e-6) / self.GRAVITY) * np.array([*vtrack, 0.0]),
                np.array([0.0, 0.0, w_yaw]),
            )
            cnt = np.zeros(3)
            cnt[:2] = hip_loc + step_adjustment + raibert_step + ang[:2]
            cnt[2] = self.foot_size
            locations[i_foot, i_mk:] = cnt
            if self.cache_cnt:
                self.planned_cnt[i_foot][abs_node] = cnt
        return locations


class CustomContactPlanner(ContactPlanner):
    """User-supplied per-cycle contact locations (each held for a gait
    cycle, the last repeated) and, optionally, a periodic sequence."""

    def __init__(self, feet_frame_names, dt_nodes, config_gait):
        super().__init__(feet_frame_names, dt_nodes, config_gait)
        self.contact_locations_full = None
        self.n_full = 0
        self.n_repeat = 3

    def set_contact_locations(self, contact_locations: np.ndarray) -> None:
        """contact_locations: (n_cycles, n_foot, 3)."""
        cl = np.asarray(contact_locations)
        if cl.ndim != 3 or cl.shape[1] != self.n_foot or cl.shape[2] != 3:
            raise ValueError(f"contact_locations: incorrect shape {cl.shape}")
        last = np.repeat(cl[-1:], self.n_repeat, axis=0)
        ext = np.concatenate([cl, last], axis=0)
        self.contact_locations_full = np.repeat(ext, self.nodes_per_cycle,
                                                axis=0).transpose(1, 0, 2)
        self.n_full = self.contact_locations_full.shape[1]

    def set_periodic_sequence(self, cnt_sequence: np.ndarray) -> None:
        if cnt_sequence.shape != self.gait_sequence.shape:
            raise ValueError(
                f"Invalid cnt_sequence shape, should be {self.gait_sequence.shape}.")
        self.gait_sequence = cnt_sequence.astype(np.int32).copy()
        self.peak_swing = 1 - self.gait_sequence

    def get_locations(self, i_node: int, n_nodes: int) -> np.ndarray:
        if self.contact_locations_full is None:
            raise RuntimeError("call set_contact_locations() before get_locations()")
        last = i_node + n_nodes
        if last < self.n_full:
            return self.contact_locations_full[:, i_node:last, :].copy()
        return self.contact_locations_full[:, -n_nodes:, :].copy()


class AcyclicContactPlanner:
    """An arbitrary finite contact sequence and contact patches (centre,
    rotation, size per foot and node); windows past the end repeat the last
    node."""

    def __init__(self):
        self.n_nodes_seq = 0
        self.cnt_sequence = None
        self.center_sequence = None
        self.rot_patch_sequence = None
        self.patch_size_sequence = None

    def set_sequence(self, cnt_sequence: np.ndarray) -> None:
        self.cnt_sequence = np.asarray(cnt_sequence)
        self.n_nodes_seq = self.cnt_sequence.shape[-1]

    def set_center_rot_size(self, cnt_center, cnt_rot, cnt_size) -> None:
        self.center_sequence = np.asarray(cnt_center)
        self.rot_patch_sequence = np.asarray(cnt_rot)
        self.patch_size_sequence = np.asarray(cnt_size)

    def _index(self, i_node, n_nodes):
        idx = np.arange(i_node, i_node + n_nodes)
        return np.clip(idx, None, self.n_nodes_seq - 1)

    def get_sequence(self, i_node: int, n_nodes: int) -> np.ndarray:
        if self.cnt_sequence is None:
            raise ValueError("Set contact sequence first")
        return self.cnt_sequence[:, self._index(i_node, n_nodes)]

    def get_peak(self, i_node: int, n_nodes: int) -> np.ndarray:
        return 1 - self.get_sequence(i_node, n_nodes)

    def get_center_rot_size_patch(self, i_node: int, n_nodes: int):
        if self.center_sequence is None:
            raise ValueError("Set patch data first")
        idx = self._index(i_node, n_nodes)
        return (
            self.center_sequence[:, idx],
            self.rot_patch_sequence[:, idx],
            self.patch_size_sequence[:, idx],
        )
