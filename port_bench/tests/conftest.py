"""Tiny copies of the benchmark's cells for CPU tests: the same files with
a batch of 4, two warm-up steps and three problems of two steps checked."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))


def make_tiny(dst: Path) -> Path:
    """A checkout-like tree under ``dst``: BENCHMARK.json with every cell
    renamed ``tiny.<cell>`` and the benchmark's configs, robots and
    metrics; returns its benchmark directory."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "port_bench" / "workloads").mkdir(parents=True)
    for sub in ("configs", "robots", "metrics"):
        shutil.copytree(BENCH / sub, dst / "port_bench" / sub)
    for w in bench["workloads"]:
        t = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        t.update(batch=4, warmup_steps=2, check=dict(t["check"], problems=3, steps=2),
                 trace={"steps": 2, "start_fraction": 0.0})
        w["name"] = t["name"] = "tiny." + w["name"]
        (dst / "port_bench" / "workloads" / f"{w['name']}.json").write_text(json.dumps(t))
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny." + c for c in m.get("workloads", [])]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst / "port_bench"


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    dst = tmp_path_factory.mktemp("tiny")
    make_tiny(dst)
    return dst
