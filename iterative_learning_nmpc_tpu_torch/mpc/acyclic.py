"""Acyclic MPC: externally supplied (non-periodic) contact sequences.

Counterpart of ``iterative_learning_nmpc_tpu/mpc/acyclic.py``: a
``LocomotionMPC`` driven by an ``AcyclicContactPlanner`` that carries a
finite contact sequence and, optionally, contact patches (centre, rotation,
size per foot and node). The first solve runs ``n_sqp_first`` SQP
iterations, later ones ``max_iter`` (RTI).

The patches map onto the OCP parameters as: ``plane_point`` and ``cnt_loc``
the patch centre, ``restrict = 1``, and half the patch's smallest size the
hard radius of the patch hinge (``patch_radius``), with the quadratic
foot-displacement pull toward the centre.
"""
from __future__ import annotations

import numpy as np

from ..gait.planner import AcyclicContactPlanner
from ..robots.spec import RobotSpec
from ..solver.sqp import make_params
from ..utils.profiling import time_fn
from .controller import LocomotionMPC


class AcyclicMPC(LocomotionMPC):
    def __init__(self, spec: RobotSpec, gait_name: str = "trot", n_sqp_first: int = 50,
                 **kwargs):
        super().__init__(spec, gait_name=gait_name, **kwargs)
        self.acyclic_planner = AcyclicContactPlanner()
        self.config_opt.max_iter_first = n_sqp_first
        self.restrict_cnt = True

    def set_contact_sequence(self, cnt_sequence: np.ndarray) -> None:
        """cnt_sequence: (4, T) contact flags, node by node."""
        self.acyclic_planner.set_sequence(cnt_sequence)

    def set_patches(self, centers: np.ndarray, rotations: np.ndarray,
                    sizes: np.ndarray) -> None:
        """centers (4, T, 3), rotations (4, T), sizes (4, T, 2)."""
        self.acyclic_planner.set_center_rot_size(centers, rotations, sizes)

    @time_fn("optimize")
    def optimize(self, q: np.ndarray, v: np.ndarray):
        """One replan from the acyclic planner's window at the node clock:
        velocity-tracking base reference, the sequence's contacts and swing
        peaks, and the patches where they are set. No phase boot: the
        sequence fixes the phase."""
        node = self.current_opt_node
        N = self.config_opt.n_nodes
        cnt = self.acyclic_planner.get_sequence(node, N + 1).astype(np.float32)
        peak = self.acyclic_planner.get_peak(node, N + 1).astype(np.float32)
        centers = sizes = None
        if self.acyclic_planner.center_sequence is not None:
            centers, _, sizes = self.acyclic_planner.get_center_rot_size_patch(node, N + 1)

        base_ref, base_ref_e = self.compute_base_ref_vel_tracking(q)
        x0 = np.concatenate([q, v]).astype(np.float32)
        plane = np.zeros((4, N + 1, 3), dtype=np.float32)
        plane[:, :, 2] = self._ground
        cnt_loc = np.zeros((4, N + 1, 3), np.float32)
        patch_radius = None
        if centers is not None:
            c = np.asarray(centers, dtype=np.float32).reshape(4, N + 1, 3)
            plane[:, :, :2] = c[:, :, :2]
            cnt_loc = c
        if sizes is not None:
            s = np.asarray(sizes, dtype=np.float32).reshape(4, N + 1, -1)
            patch_radius = 0.5 * s.min(axis=-1)

        params = make_params(
            self.solver, x0, cnt, peak=peak, plane_point=plane,
            cnt_loc=cnt_loc, patch_radius=patch_radius,
            restrict=1.0 if centers is not None else 0.0,
            base_ref=base_ref.astype(np.float32),
            base_ref_e=base_ref_e.astype(np.float32),
            joint_ref=self.joint_ref.astype(np.float32),
            step_height=self.config_gait.step_height + self._ground,
            ground_height=self._ground)
        return self._solve_plan(params, node)
