"""A cell, its traffic, its configuration and its metric readers are found
by name: a dummy cell added as files alone is loaded without an edit."""
import json
import shutil
from pathlib import Path

from port_bench.harness import cell as cells

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_dummy_cell_found_by_file_name(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy_cfg.b8_n25", "config": "dummy_cfg",
                               "traffic": "b8_n25", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.reading", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "solver loop",
                               "moves": "solves_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "port_bench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, pb / sub)
    cfg = json.loads((BENCH / "configs" / "go2_trot.json").read_text())
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(dict(cfg, name="dummy_cfg")))
    t = json.loads((BENCH / "workloads" / "go2_trot.b1024_n100.json").read_text())
    t.update(name="dummy_cfg.b8_n25", config="dummy_cfg", batch=8, n_nodes=25, time_horizon=1.0)
    (pb / "workloads" / "dummy_cfg.b8_n25.json").write_text(json.dumps(t))
    (pb / "metrics" / "dummy.reading.py").write_text("def read(ctx):\n    return ctx['B'] * 2\n")

    c = cells.load_cell("dummy_cfg.b8_n25", root=tmp_path, bench_dir=pb)
    assert c.traffic["batch"] == 8 and c.opt["n_nodes"] == 25 and c.config["name"] == "dummy_cfg"
    assert [m["name"] for m in c.end_to_end] == ["solves_per_s", "rti_step_ms_p95", "setup_s"]
    # listed metrics go to their cells only; an unlisted one to every cell that
    # reports what it moves
    assert [m["name"] for m in c.per_layer] == ["dummy.reading"]
    assert cells.load_reader("dummy.reading", pb)({"B": 8}) == 16
    go2 = cells.load_cell("go2_trot.b1024_n100", root=tmp_path, bench_dir=pb)
    names = {m["name"] for m in go2.per_layer}
    assert "riccati_sweep_terminal_roofline" in names and "riccati_rollout_roofline" not in names
    assert "dummy.reading" in names
