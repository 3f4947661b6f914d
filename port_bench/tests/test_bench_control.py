"""The control on the card: the plain reference in float32 with TF32 matrix
products, put in the program's place, reads ``correct`` false, and the
program reads true, at a batch of 64 of each cell (the readings at the
cells' own sizes are ``port_bench/control.py``'s)."""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from port_bench.harness import bench, cell as cells, result
from port_bench.reference import inputs as ref_inputs
from port_bench.reference.robot import load_robot

CONTROL = Path(__file__).resolve().parents[1] / "control.py"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["go2_trot.b1024_n100", "solo12_trot.b4096_n25"])
def test_control_reads_incorrect(tiny_tree, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist only there")
    spec = importlib.util.spec_from_file_location("port_bench_control", CONTROL)
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    cell = cells.load_cell("tiny." + name, root=tiny_tree, bench_dir=tiny_tree / "port_bench")
    cell.traffic["batch"] = 64
    dev = torch.device("cuda", 0)
    rob = cell.config["robot"]
    nom = ref_inputs.nominal_problem(
        cell.opt, cell.config["gait"], cell.traffic["motion"],
        load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"], rob["base_height_home"]))
    sound = bench.run(cell, 2**31 + 99, 1.0, False, dev, time.perf_counter())
    assert result.assemble(sound, False)[0]["correct"] is True
    ctrl = bench.run(cell, 2**31 + 99, 0.0, False, dev, time.perf_counter(),
                     step_fn=ctl.control_step(cell, nom, dev), record_steps=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert result.assemble(ctrl, False)[0]["correct"] is False
