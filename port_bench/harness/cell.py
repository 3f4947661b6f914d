"""A cell as data: its entry in BENCHMARK.json, its traffic file, its
configuration file and the readers of its per-layer metrics, all found by
name.

- ``BENCHMARK.json`` at the checkout's root: the cell's entry, its metrics;
- ``port_bench/workloads/<cell>.json``: the traffic (batch, horizon, noise,
  warm-up, what the check samples) and the limits of the check;
- ``port_bench/configs/<config>.json``: robot, gait, OCP settings, costs;
- ``port_bench/metrics/<metric>.py``: one reader per per-layer metric, a
  function ``read(ctx)`` that returns the value or None.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    traffic: dict      # workloads/<name>.json
    config: dict       # configs/<config>.json
    end_to_end: list   # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list    # BENCHMARK.json per_layer entries this cell reports

    @property
    def opt(self) -> dict:
        """The configuration's settings with the cell's horizon."""
        return dict(self.config, n_nodes=self.traffic["n_nodes"],
                    time_horizon=self.traffic["time_horizon"])

    root: Path = ROOT
    bench_dir: Path = BENCH_DIR

    def path(self, rel: str) -> Path:
        return self.root / rel


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with a ``workloads`` key is the listed cells'; a per-layer
    one without it belongs to every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, its files under
    ``bench_dir``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    traffic = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    config = json.loads((bench_dir / "configs" / f"{entry['config']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, entry, traffic, config, e2e, per_layer, root, bench_dir)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``<bench_dir>/metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
