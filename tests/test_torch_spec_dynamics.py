"""PyTorch port vs the JAX package: robot spec and batched dynamics.

Inputs come from a numpy seed and go through both packages on the CPU.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.robots.spec import _TENSOR_FIELDS

B = 32
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def specs():
    return jax_go2(), torch_go2(device="cpu")


@pytest.fixture(scope="module")
def states(specs):
    rng = np.random.default_rng(7)
    q = (np.asarray(specs[0].q_home)[None]
         + 0.3 * rng.standard_normal((B, 18))).astype(np.float32)
    v = rng.standard_normal((B, 18)).astype(np.float32)
    a = (3.0 * rng.standard_normal((B, 18))).astype(np.float32)
    f = (30.0 * rng.standard_normal((B, 4, 3))).astype(np.float32)
    return q, v, a, f


def test_go2_spec_matches_jax(specs):
    js, ts = specs
    for name in ("name", "nv", "nu", "parent", "jtype", "foot_body",
                 "feet_frame_names"):
        assert getattr(ts, name) == getattr(js, name), name
    for name in _TENSOR_FIELDS:
        t = getattr(ts, name)
        assert t.dtype == torch.float32, name
        # both packages round the same float64 table to float32: bit-equal
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("fn", ["foot_positions", "foot_velocities", "rnea"])
def test_dynamics_match_jax(specs, states, fn):
    js, ts = specs
    q, v, a, f = states
    if fn == "foot_positions":
        ref = jax.vmap(lambda q_: jdyn.foot_positions(js, q_))(q)
        out = tdyn.foot_positions(ts, torch.as_tensor(q))
    elif fn == "foot_velocities":
        ref = jax.vmap(lambda q_, v_: jdyn.foot_velocities(js, q_, v_))(q, v)
        out = tdyn.foot_velocities(ts, torch.as_tensor(q), torch.as_tensor(v))
    else:
        ref = jax.vmap(lambda q_, v_, a_, f_: jdyn.rnea(js, q_, v_, a_, f_))(q, v, a, f)
        out = tdyn.rnea(ts, *map(torch.as_tensor, (q, v, a, f)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    # fp32: the two packages associate the same sums differently (and the
    # port differentiates the base angular velocity analytically where JAX
    # uses a jvp); 1e-5 of the output scale is ~100 ulps of headroom
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * scale)


def test_port_imports_without_jax():
    """The port and every module of it import with JAX made unimportable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil
        import iterative_learning_nmpc_tpu_torch as port
        mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for name in mods:
            importlib.import_module(name)
        assert "iterative_learning_nmpc_tpu_torch.mpc.controller" in mods
        import torch
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
               or m.startswith("jax.") or m.startswith("iterative_learning_nmpc_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
