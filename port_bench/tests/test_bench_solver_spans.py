"""The five readers of the port's solve records give the values their
definitions say on synthetic records, and None where there is no record:
the traced run of a program that keeps none, or of the control."""
import pytest

from port_bench.harness import cell as cells, solver_spans

MS = 1_000_000   # ns


def _record(solve, passes, active, syncs, pass_ms, sync_ms, B=8):
    spans = [("sqp.solve", -1, 0, 100 * MS)]
    spans += [("sqp.sync", 0, 0, int(ms * MS)) for ms in sync_ms]
    spans += [("sqp.pass", 0, 0, int(ms * MS)) for ms in pass_ms]
    counters = {"solver.solves": 1, "solver.al_passes": passes,
                "solver.problem_passes": B * passes,
                "solver.active_problem_passes": active, "solver.host_syncs": syncs}
    return dict(solve=solve, B=B, N=25, routes={}, counters=counters, spans=spans)


# one solve of one pass (8 of 8 problems), one of three (8, 2, 1)
RECORDS = [_record(1, 1, 8, 3, [2.0], [4.0, 1.0, 0.5]),
           _record(2, 3, 11, 5, [3.0, 1.0, 2.0], [6.0, 1.0, 1.0, 0.5, 0.5])]
EXPECTED = {"solver.al_passes_per_step": 2.0,
            "solver.active_pass_share": 100.0 * 19 / 32,
            "solver.host_syncs_per_step": 4.0,
            "solver.pass_enqueue_ms": 2.0,
            "solver.sync_wait_ms_per_step": 7.25}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_values_and_none_without_records(monkeypatch, name):
    read = cells.load_reader(name)
    monkeypatch.setattr(solver_spans, "records", lambda: list(RECORDS))
    assert read({}) == pytest.approx(EXPECTED[name], rel=1e-12)
    monkeypatch.setattr(solver_spans, "records", lambda: [])
    assert read({}) is None


def test_records_of_a_program_without_them(monkeypatch):
    from iterative_learning_nmpc_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "solve_records", lambda: iter(RECORDS))
    assert solver_spans.records() == RECORDS
    monkeypatch.delattr(profiling, "solve_records")
    assert solver_spans.records() == []
