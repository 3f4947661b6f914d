"""The port's contact-restricted controller against the JAX package's, on
the CPU, through the goldens of ``scripts/make_torch_controller_modes_golden.py``
(JAX on the CPU; no JAX controller is compiled here).

- ``contact_planner="raibert"`` (Go2 trot, 0.3 m/s): the first plan's
  footsteps and base references exact to 1e-6 (float64 host code fed a
  float32 CoM), its solution within the bench's rel |dU| / (1 + |U|) gate
  of 1e-3;
- ``contact_planner="custom"`` with a fixed footstep table: the same;
- the restricted parameters: active feet pinned to the planned xy,
  ``restrict`` = 1, and no phase boot; the cyclic controller's parameters
  exactly the unrestricted ones it had before contact restriction was
  ported (one code path).

~6 s of worker time (two 15-iteration plans of one problem).
"""
import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.mpc import controller as controller_module
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

torch.set_num_threads(1)
GATE = 1.0e-3
DATA = "tests/data/{}_golden.npz"


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.fixture(scope="module")
def spec():
    return go2_spec(device="cpu")


def first_plan(spec, planner, golden, monkeypatch=None):
    mpc = LocomotionMPC(spec, gait_name="trot", contact_planner=planner, solve_async=False,
                        device="cpu")
    if planner == "custom":
        mpc.contact_planner.set_contact_locations(golden["table"])
    mpc.set_command(golden["v_des"])
    seen = {}
    if monkeypatch is not None:
        make = controller_module.make_params
        monkeypatch.setattr(controller_module, "make_params",
                            lambda *a, **k: seen.setdefault("kw", (k, make(*a, **k)))[1])
    plan = mpc.optimize(golden["q0"], golden["v0"])
    mpc.close()
    return mpc, plan, seen.get("kw", (None, None))


@pytest.mark.parametrize("planner", ["raibert", "custom"])
def test_restricted_first_plan_matches_jax(spec, planner, monkeypatch):
    g = np.load(DATA.format(f"go2_trot_{planner}"))
    mpc, plan, (kw, params) = first_plan(spec, planner, g, monkeypatch)
    assert mpc.restrict_cnt and not mpc.phase_aligned_boot and mpc.boot_offsets == []
    np.testing.assert_allclose(mpc._last_cnt_loc, g["cnt_loc"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(mpc._last_base_ref, g["base_ref"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(mpc._last_base_ref_e, g["base_ref_e"], rtol=0, atol=1e-6)
    assert rel(mpc._U_prev[0].numpy(), g["U"]) <= GATE
    assert rel(plan[0], g["q_plan"]) <= GATE and rel(plan[4], g["tau_ff"]) <= GATE
    # the restricted parameters: restrict on, footsteps as cnt_loc, the
    # plane's xy at the footsteps where every coordinate is given, ground z
    assert float(params.restrict) == 1.0
    loc = g["cnt_loc"]
    np.testing.assert_array_equal(params.cnt_loc[0].numpy(), loc.astype(np.float32))
    given = np.all(loc != 0.0, axis=-1)
    plane = params.plane_point[0].numpy()
    np.testing.assert_array_equal(plane[..., :2][given], loc[..., :2][given].astype(np.float32))
    assert np.all(plane[..., :2][~given] == 0.0)
    np.testing.assert_array_equal(plane[..., 2], np.float32(mpc._ground))


def test_cyclic_parameters_are_the_unrestricted_ones(spec, monkeypatch):
    """The cyclic planner's replan builds the parameters it built before
    contact restriction was ported: zero footsteps, restrict 0, the plane
    at the ground everywhere, the velocity-tracking references."""
    g = np.load(DATA.format("go2_trot_closed_loop"))
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device="cpu")
    assert not mpc.restrict_cnt and mpc.phase_aligned_boot
    mpc.set_command(g["v_des"])
    seen = {}
    monkeypatch.setattr(controller_module, "make_params", lambda *a, **k: seen.setdefault(
        "kw", k))
    monkeypatch.setattr(mpc, "_solve_plan", lambda params, node: None)
    monkeypatch.setattr(controller_module, "merit_phase_boot",
                        lambda solver, p, w, peaks=None: (p, 0, None))
    mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    kw = seen["kw"]
    N = mpc.config_opt.n_nodes
    assert kw["restrict"] == 0.0 and kw.get("patch_radius") is None
    np.testing.assert_array_equal(kw["cnt_loc"], np.zeros((4, N + 1, 3), np.float32))
    plane = np.zeros((4, N + 1, 3), np.float32)
    plane[:, :, 2] = mpc._ground
    np.testing.assert_array_equal(kw["plane_point"], plane)
    base_ref, base_ref_e = mpc.compute_base_ref_vel_tracking(g["q0"])
    np.testing.assert_array_equal(kw["base_ref"], base_ref.astype(np.float32))
    np.testing.assert_array_equal(kw["base_ref_e"], base_ref_e.astype(np.float32))
    assert mpc._last_cnt_loc is None


def test_base_reference_from_footsteps(spec):
    """compute_base_ref_cnt_restricted: between the centres of the first
    and last nodes where every foot has a location, all three coordinates
    nonzero (0.35 / 0.65), else the first and last nodes; the nominal
    height."""
    mpc = LocomotionMPC(spec, contact_planner="custom", solve_async=False, device="cpu")
    loc = np.zeros((4, 5, 3))
    loc[:, 1] = [[1.0, 1.0, 0.01]] * 4
    loc[:, 3] = [[3.0, -1.0, 0.01]] * 4
    loc[0, 4] = 9.0                           # one foot only: not a full node
    loc[:, 2, :2] = 5.0                       # z = 0: not given
    ref, ref_e = mpc.compute_base_ref_cnt_restricted(np.zeros(18), loc)
    np.testing.assert_allclose(ref[:3], [0.35 * 1 + 0.65 * 3, 0.35 - 0.65,
                                         mpc.config_gait.nom_height])
    np.testing.assert_allclose(ref_e[:3], [3.0, -1.0, mpc.config_gait.nom_height])
    loc[:, 1] = loc[:, 3] = 0.0
    ref, ref_e = mpc.compute_base_ref_cnt_restricted(np.zeros(18), loc)
    np.testing.assert_allclose(ref_e[:2], loc[:, -1, :2].mean(0))
    mpc.close()
