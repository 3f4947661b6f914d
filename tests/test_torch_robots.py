"""The port's second robot and URDF ingestion against the JAX package's, on
the CPU: ``solo12_spec`` field by field, ``parse_urdf`` of both shipped
descriptions (``assets/go2.urdf``, ``assets/solo12.urdf``) and of a vendor-
style file with rotated frames and unnamed joints, the ``spec_to_urdf``
round trip, the catalog's ``urdf_path=`` entries, Solo12's mass-scaled
contact parameters, and Solo12's dynamics. ~8 s of worker time (three
jitted JAX vmaps of a dynamics function).
"""
import os

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec as jax_solo12
from iterative_learning_nmpc_tpu.robots.urdf import parse_urdf as jax_parse
from iterative_learning_nmpc_tpu.robots.urdf import spec_to_urdf as jax_export
from iterative_learning_nmpc_tpu.sim import jax_sim
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec
from iterative_learning_nmpc_tpu_torch.robots.spec import _TENSOR_FIELDS
from iterative_learning_nmpc_tpu_torch.robots.urdf import parse_urdf, spec_to_urdf
from iterative_learning_nmpc_tpu_torch.sim import device_sim

from test_urdf import _vendor_urdf_xml

torch.set_num_threads(1)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
META = ("name", "nv", "nu", "parent", "jtype", "foot_body", "feet_frame_names")


def assert_same_spec(t, j, meta=META):
    """Every tensor field of the port's spec equal to the JAX spec's array,
    bit for bit, and the metadata equal."""
    for f in meta:
        assert tuple(np.atleast_1d(getattr(t, f))) == tuple(np.atleast_1d(getattr(j, f))), f
    for f in _TENSOR_FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_solo12_spec_matches_jax():
    assert_same_spec(solo12_spec(device="cpu"), jax_solo12())


@pytest.mark.parametrize("asset", ["go2.urdf", "solo12.urdf"])
def test_parse_urdf_matches_jax(asset):
    path = os.path.join(ASSETS, asset)
    assert_same_spec(parse_urdf(path, device="cpu"), jax_parse(path))


def test_parse_urdf_vendor_file_matches_jax():
    """Rotated joint origins, a rotated fixed frame ahead of a movable
    joint, rotated inertials and vendor joint names: the residual-rotation
    folding and the classification of both packages agree."""
    xml = _vendor_urdf_xml()
    assert_same_spec(parse_urdf(xml, device="cpu"), jax_parse(xml))


@pytest.mark.parametrize("make, jmake", [(go2_spec, jax_go2), (solo12_spec, jax_solo12)])
def test_spec_to_urdf_round_trip(make, jmake):
    """The export is the JAX package's text, and parsing it back gives the
    spec (q_home aside: URDF carries no nominal pose)."""
    spec = make(device="cpu")
    text = spec_to_urdf(spec)
    assert text == jax_export(jmake())
    back = parse_urdf(text, device="cpu")
    assert back.parent == spec.parent and back.foot_body == spec.foot_body
    for f in _TENSOR_FIELDS:
        if f != "q_home":
            assert float((getattr(back, f) - getattr(spec, f)).abs().max()) < 1e-6, f


@pytest.mark.parametrize("make, asset", [(go2_spec, "go2.urdf"), (solo12_spec, "solo12.urdf")])
def test_catalog_urdf_path_gives_the_table(make, asset):
    """``urdf_path=`` ingests the shipped description of the parameter
    table, with the catalog's nominal pose."""
    table = make(device="cpu")
    ingested = make(device="cpu", urdf_path=os.path.join(ASSETS, asset))
    assert ingested.name == table.name
    for f in _TENSOR_FIELDS:
        assert float((getattr(ingested, f) - getattr(table, f)).abs().max()) < 1e-6, f


def test_solo12_contact_params_match_jax():
    jcp = jax_sim.contact_params_for(jax_solo12())
    tcp = device_sim.contact_params_for(solo12_spec(device="cpu"), device="cpu")
    for name in ("stiffness", "damping", "friction_mu", "vel_smoothing"):
        assert float(getattr(tcp, name)) == float(getattr(jcp, name)), name


@pytest.mark.parametrize("fn", ["forward_dynamics", "mass_matrix", "com_position"])
def test_solo12_dynamics_match_jax(fn):
    """At tests/test_torch_plant.py's tolerances: forward dynamics 2e-6 of
    the output scale, the others 1e-5 (fp32, sums associated differently).
    Solo12's calf inertias (3.2e-6) make M(q) worse conditioned than
    Go2's."""
    js, ts = jax_solo12(), solo12_spec(device="cpu")
    rng = np.random.default_rng(5)
    q = (np.asarray(js.q_home)[None] + 0.3 * rng.standard_normal((16, 18))).astype(np.float32)
    v = rng.standard_normal((16, 18)).astype(np.float32)
    f = (5.0 * rng.standard_normal((16, 4, 3))).astype(np.float32)
    tau = rng.standard_normal((16, 12)).astype(np.float32)
    jf = {"forward_dynamics": lambda q, v, f, t: jdyn.forward_dynamics(js, q, v, t, f),
          "mass_matrix": lambda q, v, f, t: jdyn.mass_matrix(js, q),
          "com_position": lambda q, v, f, t: jdyn.com_position(js, q)}[fn]
    ref = np.asarray(jax.jit(jax.vmap(jf))(q, v, f, tau))
    q_, v_, f_, t_ = map(torch.as_tensor, (q, v, f, tau))
    out = {"forward_dynamics": lambda: tdyn.forward_dynamics(ts, q_, v_, t_, f_),
           "mass_matrix": lambda: tdyn.mass_matrix(ts, q_),
           "com_position": lambda: tdyn.com_position(ts, q_)}[fn]().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=(2e-6 if fn == "forward_dynamics" else 1e-5) * scale)
