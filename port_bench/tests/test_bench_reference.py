"""The plain reference against the port's CPU path (its plain twins, float32)
at a batch of 4: the cold start, and every recorded step's U, X,
multipliers and merit within the cell's limits, at N = 25 (the fused
Riccati route) and N = 100 (the split route)."""
import time

import pytest
import torch

from port_bench.harness import bench, cell as cells
from port_bench.reference import inputs as ref_inputs
from port_bench.reference.robot import load_robot


def _cell(tiny_tree, name):
    return cells.load_cell("tiny." + name, root=tiny_tree, bench_dir=tiny_tree / "port_bench")


@pytest.mark.parametrize("name", ["solo12_trot.b4096_n25", "go2_trot.b1024_n100"])
def test_reference_matches_port_cpu_path(tiny_tree, name):
    cell = _cell(tiny_tree, name)
    res = bench.run(cell, 2**31 + 12345, 0.0, False, torch.device("cpu"), time.perf_counter(),
                    record_steps=2)
    nums = res["numbers"]
    assert res["failed"] == 0 and nums["solves_compared"] >= 2 * 3
    assert nums["start"] < 1e-6
    for k, lim in cell.traffic["limits"].items():
        assert nums[k] <= lim, (k, nums[k], lim)


def test_cold_start_and_inputs_match_port(tiny_tree):
    """The reference's own inputs and cold start are the port's, from the
    same configuration file: parsed robot, contact schedule, x0, U."""
    from port_bench.harness import program

    cell = _cell(tiny_tree, "go2_trot.b1024_n100")
    rob = cell.config["robot"]
    robot = load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"], rob["base_height_home"])
    nom = ref_inputs.nominal_problem(cell.opt, cell.config["gait"], cell.traffic["motion"], robot)
    solver, spec = program.build_solver(cell, "cpu")
    assert abs(float(spec.mass.sum()) - float(robot.total_mass())) < 1e-5
    assert torch.allclose(spec.torque_limit.double(), robot.torque_limit, rtol=1e-6)
    x0 = torch.as_tensor(nom["x0"], dtype=torch.float32).repeat(2, 1)
    X, U = solver.cold_start(program.make_params(solver, nom, x0))
    X0, U0 = ref_inputs.cold_start(robot, ref_inputs.batch_params(nom, x0.double(), 0.04))
    assert torch.allclose(X.double(), X0, atol=1e-6) and torch.allclose(U.double(), U0, atol=1e-4)


def test_line_search_branches_leave_the_reference_answer(tiny_tree):
    """Following rounding-ambiguous line-search choices both ways returns the
    reference's own answer when that is what the program returned, over the
    cold step and the first warm steps, where such choices occur (Solo12)."""
    from port_bench.reference.rti import RTI

    cell = _cell(tiny_tree, "solo12_trot.b4096_n25")
    rob = cell.config["robot"]
    robot = load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"], rob["base_height_home"])
    nom = ref_inputs.nominal_problem(cell.opt, cell.config["gait"], cell.traffic["motion"], robot)
    rti = RTI(robot, cell.opt, cell.config, torch.float64, "cpu")
    g = torch.Generator().manual_seed(5)
    x0 = torch.as_tensor(nom["x0"]) + 0.01 * torch.randn(16, 36, generator=g, dtype=torch.float64)
    p = ref_inputs.batch_params(nom, x0, rti.h)
    X, U = ref_inputs.cold_start(robot, p)
    le, li = p["lam_eq"], p["lam_ineq"]
    for _ in range(3):
        own = rti.step(X, U, le, li, p)
        br = rti.step(X, U, le, li, p, reported=own["qp_iters"], judge=own["U"])
        for k in own:
            assert torch.equal(own[k], br[k]), k
        X, U, le, li = own["X"], own["U"], own["lam_eq"], own["lam_ineq"]
