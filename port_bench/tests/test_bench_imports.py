"""Nothing under port_bench imports JAX, Flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "iterative_learning_nmpc_tpu"}
PORT = "iterative_learning_nmpc_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(BENCH)), m) for p in BENCH.rglob("*.py")
             for m in _imports(p) if m in BANNED}
    assert not found


def test_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        mods = set(_imports(p))
        assert PORT not in mods and not (mods & BANNED), p
        assert "port_bench" not in mods, p   # relative imports inside reference/ only


def test_loaded_harness_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import port_bench.harness.bench, "
            "port_bench.harness.result, port_bench.harness.program as p, torch; "
            "from port_bench.harness import cell; c = cell.load_cell('go2_trot.b1024_n100'); "
            "p.build_solver(c, 'cpu'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH.parent), BANNED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("loads_jax", [False, True], ids=["clean", "reader_loads_jax"])
def test_no_result_line_once_a_reader_loads_jax(tiny_tree, tmp_path, monkeypatch, capsys,
                                                loads_jax):
    """A module named ``jax`` that a per-layer reader loads after the window
    (readers load once the window has closed) leaves no result line."""
    import io
    import json
    import time

    import torch

    from port_bench.harness import bench, cell as cells, result

    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
        monkeypatch.delitem(sys.modules, m)
    pb = tmp_path / "tree" / "port_bench"
    shutil.copytree(tiny_tree, tmp_path / "tree")
    body = "import importlib\n\n\ndef read(ctx):\n"
    body += "    importlib.import_module('jax')\n" if loads_jax else ""
    (pb / "metrics" / "dummy.reader.py").write_text(body + "    return 1.0\n")
    cell = cells.load_cell("tiny.solo12_trot.b4096_n25", root=pb.parent, bench_dir=pb)
    cell.per_layer = [{"name": "dummy.reader", "unit": "1"}]
    res = bench.run(cell, 2**31 + 5, 0.0, False, torch.device("cpu"), time.perf_counter(),
                    record_steps=1)
    assert not result.jax_modules()
    out = io.StringIO()
    rc = result.emit(res, True, out=out)
    assert ("jax" in sys.modules) is loads_jax
    if loads_jax:
        assert rc == 3 and out.getvalue() == ""
        assert "loaded once the window closed: jax" in capsys.readouterr().err
    else:
        assert rc == 0 and json.loads(out.getvalue())["metrics"]["dummy.reader"]["value"] == 1.0
