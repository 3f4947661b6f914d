"""A run with the timed path broken underneath reads ``correct`` false.

The harness's look for a card is skipped: the run drives the port's CPU
path at a batch of 4 through set-up, the window, the check and the result
line, with the cell's own limits. Each fault a one-chip cell of warm RTI
chains can have: a step that returns its state unchanged; half of the batch
left out, the mean of the rest in its place; an answer altered where it is
produced (the step's change doubled); the inner loop's stop turned (the
violation read 0.8 of what it is, so that a problem stops a pass early
wherever it lies within 1.25 qp_tol). A sound run reads true."""
import time

import pytest
import torch

from port_bench.harness import bench, cell as cells, program, result


def _unchanged(solver, X, U, le, li, params):
    _, _, _, _, st = program.rti_step(solver, X, U, le, li, params)
    return X, U, le, li, st


def _half_batch(solver, X, U, le, li, params):
    h = X.shape[0] // 2
    Xn, Un, len_, lin, st = program.rti_step(solver, X, U, le, li, params)
    mean = lambda t: torch.cat([t[:h], t[:h].mean(0, keepdim=True).expand_as(t[h:])])
    return mean(Xn), mean(Un), mean(len_), mean(lin), st


def _doubled(solver, X, U, le, li, params):
    Xn, Un, len_, lin, st = program.rti_step(solver, X, U, le, li, params)
    return X + 2 * (Xn - X), U + 2 * (Un - U), len_, lin, st


def _violation_low(solver, X, U, le, li, params):
    """The program's violation read 0.8 of what it is: its qp_tol / 0.8."""
    if not hasattr(solver, "fault_tol"):
        solver.fault_tol = solver.opt.qp_tol
    solver.set_qp_tol(solver.fault_tol / 0.8)
    return program.rti_step(solver, X, U, le, li, params)


# the stop fault shows where some problem's violation lies between
# (1 + PASS_BAND) and 1.25 qp_tol: at a batch of 8, three window steps recorded
STOP = dict(batch=8, record_steps=3)


@pytest.mark.parametrize("fault, size", [(None, {}), (_unchanged, {}), (_half_batch, {}),
                                         (_doubled, {}), (None, STOP), (_violation_low, STOP)],
                         ids=["sound", "unchanged", "half_batch", "doubled", "sound_b8",
                              "violation_low"])
def test_fault_reads_incorrect(tiny_tree, fault, size):
    cell = cells.load_cell("tiny.solo12_trot.b4096_n25", root=tiny_tree,
                           bench_dir=tiny_tree / "port_bench")
    if size:
        cell.traffic["batch"] = cell.traffic["check"]["problems"] = size["batch"]
    res = bench.run(cell, 2**32 + 7, 0.0 if size else 0.3, False, torch.device("cpu"),
                    time.perf_counter(), step_fn=fault, record_steps=size.get("record_steps"))
    line = result.assemble(res, False)[0]
    assert line["correct"] is (fault is None), line["check"]
    assert list(line)[-1] == "check"
    if size:
        assert (line["check"]["passes_off"]["value"] > 0) is (fault is not None)
