"""The port's config layer (``utils/config_io.py``) against the JAX package's
and PyYAML, on the CPU.

The port reads and writes its configs with its own YAML codec (the GPU
machines have no PyYAML). What it writes, PyYAML's ``safe_load`` reads to
the same values; what the JAX ``save_config`` writes (PyYAML block style),
the port reads to the JAX ``load_config``'s config; overrides, coercion
and the unknown-key error are the JAX layer's; input outside the subset
raises ``ValueError`` naming the construct. No JAX compile; ~1 s of worker
time.
"""
import dataclasses
import math

import pytest
import yaml

from iterative_learning_nmpc_tpu.learning import dagger as jdagger
from iterative_learning_nmpc_tpu.learning import datagen as jdatagen
from iterative_learning_nmpc_tpu.learning import train as jtrain
from iterative_learning_nmpc_tpu.utils import config_io as jio
from iterative_learning_nmpc_tpu_torch.learning.dagger import SafeDaggerConfig
from iterative_learning_nmpc_tpu_torch.learning.datagen import (
    DataCollectionConfig, PretrainConfig)
from iterative_learning_nmpc_tpu_torch.learning.train import TrainConfig
from iterative_learning_nmpc_tpu_torch.utils import config_io as tio

# (port config, the JAX twin class) with values that exercise the codec:
# nested sequences, None, exponents, strings that look like numbers,
# strings that need quotes
CASES = [
    (SafeDaggerConfig(unsafe_height_bounds=(0.2, 0.4), goals=((0.15, 0.0, 0.0), (-0.1, 0.05, 0.0))),
     jdagger.SafeDaggerConfig),
    (SafeDaggerConfig(), jdagger.SafeDaggerConfig),
    (TrainConfig(learning_rate=1e-7, run_name="0.3", save_dir="a b#c: d", batch_norm=False),
     jtrain.TrainConfig),
    (TrainConfig(run_name="yes", save_dir="it's ~/x", learning_rate=1.5e20), jtrain.TrainConfig),
    (DataCollectionConfig(v_des=(0.3, -0.0, 1e-12), record_dir="./data"),
     jdatagen.DataCollectionConfig),
    (PretrainConfig(n_goals=3, vy_range=(-0.2, 0.2)), jdatagen.PretrainConfig),
]


def as_yaml_values(cfg):
    """The config as PyYAML reads a dump of it: tuples as lists."""
    def clean(v):
        return [clean(x) for x in v] if isinstance(v, (list, tuple)) else v
    return {k: clean(v) for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("i", range(len(CASES)))
def test_port_dump_reads_back_in_pyyaml_and_port(tmp_path, i):
    cfg, _ = CASES[i]
    p = str(tmp_path / "c.yaml")
    tio.save_config(cfg, p)
    text = open(p).read()
    assert yaml.safe_load(text) == as_yaml_values(cfg)
    assert tio.load_yaml(text) == as_yaml_values(cfg)
    assert tio.load_config(type(cfg), p) == cfg


@pytest.mark.parametrize("i", range(len(CASES)))
def test_port_reads_jax_save_config(tmp_path, i):
    cfg, jcls = CASES[i]
    jcfg = jcls(**dataclasses.asdict(cfg))
    p = str(tmp_path / "j.yaml")
    jio.save_config(jcfg, p)
    text = open(p).read()
    assert tio.load_yaml(text) == yaml.safe_load(text)
    got = tio.load_config(type(cfg), p)
    assert dataclasses.asdict(got) == dataclasses.asdict(jio.load_config(jcls, p))
    assert got == cfg
    # and the JAX layer reads the port's file to the same config
    q = str(tmp_path / "t.yaml")
    tio.save_config(cfg, q)
    assert dataclasses.asdict(jio.load_config(jcls, q)) == dataclasses.asdict(cfg)


def test_overrides_coercion_and_unknown_keys_as_jax(tmp_path):
    ovs = ["n_epochs=3", "sim_time=2.5", "goals=[[0.1,0,0],[0,0,0]]", "learning_rate=1e-4",
           "monitor=v1", "unsafe_height_bounds=[0.2, 0.4]", "seed=7"]
    t = tio.load_config(SafeDaggerConfig, overrides=ovs)
    j = jio.load_config(jdagger.SafeDaggerConfig, overrides=ovs)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert isinstance(t.goals[0], tuple) and t.learning_rate == 1e-4
    f = tio.load_config(DataCollectionConfig, overrides=["force_magnitude=[40, 60]"])
    assert f.force_magnitude == (40.0, 60.0)
    p = tmp_path / "bad.yaml"
    p.write_text("learning_rat: 1e-4\n")
    with pytest.raises(KeyError):
        tio.load_config(TrainConfig, str(p))
    with pytest.raises(KeyError):
        tio.apply_overrides(TrainConfig(), ["nope=1"])
    with pytest.raises(ValueError):
        tio.apply_overrides(TrainConfig(), ["n_epochs"])
    p.write_text("# partial\nn_epochs: 7   # a comment\nbatch_size: 64\n")
    cfg = tio.load_config(TrainConfig, str(p))
    assert cfg.n_epochs == 7 and cfg.batch_size == 64 and cfg.learning_rate == 2e-3


def test_scalars_resolve_as_pyyaml():
    plain = ["1", "-3", "0", "1_000", "1.5", "-.5", "1.", "1.0e-07", "6.02e+23", ".inf",
             "-.inf", "true", "False", "yes", "off", "ON", "null", "~", "Null", "abc",
             "1e-4", "0.3.1", "./x", "v2", "a-b", "'quoted'", '"dq \\" x"', "'it''s'",
             "[1, 2.5, [3, null]]", "[]", "[a, 'b c']"]
    for s in plain:
        assert tio.load_yaml(f"k: {s}\n") == yaml.safe_load(f"k: {s}\n"), s
    nan = tio.load_yaml("k: .nan\n")["k"]
    assert math.isnan(nan)
    # the writer's floats keep a '.' and a signed exponent, as YAML 1.1 needs
    for x in (1e-7, 1e20, 0.1, -2.0, 3e-300, float("inf"), float("-inf")):
        assert yaml.safe_load(tio.dump_yaml({"k": x})) == {"k": x}


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\n", "anchor"), ("a: *x\n", "alias"), ("a: !!int 3\n", "tag"),
    ("a: |\n  x\n", "block scalar"), ("a:\n  b: 1\n", "nested mapping"),
    ("a: 0x1f\n", "hex"), ("a: 017\n", "octal"), ("a: 2001-12-14\n", "timestamp"),
    ("a: [[[1]]]\n", "nested more than once"), ("- 1\n", "top-level sequence"),
    ("a: {b: 1}\n", "flow mapping"), ("a:\n- b: 1\n", "mapping inside a sequence"),
    ("a: 1\n---\nb: 2\n", "second document"), ("a: 'x\n", "unterminated"),
    ("a b: 1\n", "key"),
])
def test_outside_the_subset_raises_naming_it(text, what):
    with pytest.raises(ValueError, match=what):
        tio.load_yaml(text)


def test_dump_refuses_what_it_cannot_write():
    for bad in ({"a": {"b": 1}}, {"a": [[[1]]]}, {"a": "x\ny"}, {"a": object()}):
        with pytest.raises(ValueError):
            tio.dump_yaml(bad)


def test_timestamped_run_dir(tmp_path):
    d = tio.timestamped_run_dir(str(tmp_path), "x")
    assert d.startswith(str(tmp_path)) and d.endswith("_x")
