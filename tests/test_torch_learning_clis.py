"""The port's five learning CLIs (``iterative_learning_nmpc_tpu_torch/
examples/``: ``collect_bc_data``, ``train_bc``, ``run_dagger``,
``collect_plant_batch``, ``analyze_dataset``), on the CPU with tiny budgets.

- Each takes the JAX CLI's flags, ``--device`` for its ``--cpu`` (read
  from the JAX scripts' ``--help``).
- ``collect_bc_data``, ``train_bc`` and ``analyze_dataset`` run in-process
  with ``--device cpu`` and write what the JAX CLIs write (npz snapshots in
  place of ``.hdf5``, the config as YAML through the port's codec), and end
  with the ``launches`` line ``run_mpc`` prints
  (``tests/test_torch_learning_clis_loops.py`` runs the other two).
- With ``mujoco``, ``matplotlib``, ``yaml`` and ``h5py`` blocked, the port
  imports, its config round-trips and ``train_bc --help`` runs.

~14 s of worker time (one short MPC rollout in MuJoCo, two one-epoch
trainings, two figures, a subprocess); the JAX CLIs only print their help.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from iterative_learning_nmpc_tpu_torch.examples import analyze_dataset, collect_bc_data, train_bc
from iterative_learning_nmpc_tpu_torch.learning.database import Database
from iterative_learning_nmpc_tpu_torch.learning.train import TrainConfig
from iterative_learning_nmpc_tpu_torch.utils.config_io import load_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("collect_bc_data", "train_bc", "run_dagger", "collect_plant_batch", "analyze_dataset")


def flags(help_text):
    return set(re.findall(r"(?<![\w-])(--[a-z_]+)", help_text))


def launches(out):
    line = [ln for ln in out.splitlines() if ln.startswith("launches: ")][-1]
    return {n: int(c) for n, c in re.findall(r"(\w+) (\d+)", line.split(":", 1)[1])}


def help_text(main, argv=None):
    """What ``main`` prints for --help (argparse exits before any import)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        if argv is None:
            main(["--help"])
        else:
            old, sys.argv = sys.argv, argv
            try:
                main()
            finally:
                sys.argv = old
    assert e.value.code == 0
    return buf.getvalue()


@pytest.mark.parametrize("name", CLIS)
def test_flags_are_the_jax_clis(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", path)
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    want = flags(help_text(jax_cli.main, [path, "--help"]))
    if "--cpu" in want:
        want = (want - {"--cpu"}) | {"--device"}
    port = importlib.import_module(f"iterative_learning_nmpc_tpu_torch.examples.{name}")
    assert flags(help_text(port.main)) == want


def test_collect_train_analyze(tmp_path, capsys):
    """collect_bc_data -> train_bc (flags, then --config/--set) ->
    analyze_dataset on the snapshot."""
    rec = str(tmp_path / "data")
    assert collect_bc_data.main(["--device", "cpu", "--record_dir", rec, "--sim_time_nominal",
                                 "0.05", "--n_perturb", "0"]) == 0
    out = capsys.readouterr().out
    snap = os.path.join(rec, "database_0.npz")
    assert f"dataset written: {snap}" in out
    assert set(launches(out)) == {"dyncore", "lingram", "riccati_rollout", "dynjac", "policy_pd"}
    assert load_config(type(collect_bc_data_cfg()), os.path.join(rec, "config.yaml")).v_des == (
        0.3, 0.0, 0.0)
    db = Database(limit=10**6)
    db.load(snap)
    assert len(db) == 50               # the nominal run's rows

    save = str(tmp_path / "pol")
    assert train_bc.main(["--dataset", snap, "--device", "cpu", "--epochs", "1",
                          "--batch_size", "16", "--save_dir", save, "--run_name", "t"]) == 0
    out = capsys.readouterr().out
    assert os.path.join(save, "policy_t_final.pkl") in out and "launches: " in out
    cfg_path = os.path.join(save, "config_t.yaml")
    assert load_config(TrainConfig, cfg_path) == TrainConfig(n_epochs=1, batch_size=16,
                                                             save_dir=save, run_name="t")
    assert train_bc.main(["--dataset", snap, "--device", "cpu", "--config", cfg_path,
                          "--set", "run_name=u", "--set", "hidden_dim=32"]) == 0
    assert os.path.exists(os.path.join(save, "policy_u_final.pkl"))
    capsys.readouterr()

    figs = str(tmp_path / "figs")
    assert analyze_dataset.main(["--dataset", snap, "--out", figs, "--figures", "pca",
                                 "actions"]) == 0
    out = capsys.readouterr().out
    assert sorted(os.listdir(figs)) == ["action_bounds.png", "pca.png"]
    assert "wrote 2 figure(s)" in out and "launches: " in out


def collect_bc_data_cfg():
    from iterative_learning_nmpc_tpu_torch.learning.datagen import DataCollectionConfig

    return DataCollectionConfig()


def test_port_imports_without_mujoco_matplotlib_yaml_h5py():
    """mujoco, matplotlib, yaml and h5py blocked: every module of the port
    imports, a config round-trips through the port's codec, train_bc --help
    runs; building a Simulator and the HDF5 snapshot path raise
    ImportError."""
    code = """
import sys
for m in ("mujoco", "matplotlib", "yaml", "h5py"):
    sys.modules[m] = None
import importlib, io, os, pkgutil, contextlib, tempfile
import iterative_learning_nmpc_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    importlib.import_module(m.name)
from iterative_learning_nmpc_tpu_torch.learning.dagger import SafeDaggerConfig
from iterative_learning_nmpc_tpu_torch.learning.database import Database
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim.mujoco_sim import Simulator
from iterative_learning_nmpc_tpu_torch.utils.config_io import load_config, save_config
from iterative_learning_nmpc_tpu_torch.examples import train_bc
d = tempfile.mkdtemp()
cfg = SafeDaggerConfig(goals=((0.1, 0.0, 0.0),), unsafe_height_bounds=(0.2, 0.4))
save_config(cfg, os.path.join(d, "c.yaml"))
assert load_config(SafeDaggerConfig, os.path.join(d, "c.yaml")) == cfg
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    try:
        train_bc.main(["--help"])
    except SystemExit as e:
        assert e.code == 0
assert "--dataset" in buf.getvalue()
for fn in (lambda: Simulator(go2_spec(device="cpu")),
           lambda: Database(10).load_saved_database(os.path.join(d, "x.hdf5"))):
    try:
        fn()
    except ImportError:
        pass
    else:
        raise SystemExit("no ImportError")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
