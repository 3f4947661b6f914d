"""Cyclic gait machines: periodic per-foot contact bitmaps (numpy host API).

Counterpart of ``GaitPlanner``/``ContactPlanner`` in
``iterative_learning_nmpc_tpu/gait/planner.py``; the bitmaps are built by
the same rule, so both packages plan identical contact schedules.
"""
from __future__ import annotations

from math import ceil
from typing import Sequence

import numpy as np

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
        for i_foot in range(self.n_foot):
            mk = float(config_gait.phase_offset[i_foot])
            bk = round((mk + float(config_gait.stance_ratio[i_foot])) % 1.0, 2)
            s, e = ceil(mk * n), ceil(bk * n)
            if mk < bk:
                seq[i_foot, s:e] = 1
            else:
                seq[i_foot, s:] = 1
                seq[i_foot, :e] = 1
        self.gait_sequence = seq
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


class ContactPlanner(GaitPlanner):
    """Cyclic gait, no location restriction."""
