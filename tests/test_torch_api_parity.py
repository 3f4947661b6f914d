"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with ``ast`` and neither is imported. For each
module of ``iterative_learning_nmpc_tpu/`` and its twin in
``iterative_learning_nmpc_tpu_torch/`` (the same path, but for the kernel
files, ``RENAMED_MODULES``), every public (no leading underscore) function,
class and method of a public class must have a counterpart of the same name:
a function, class or module-level name in the twin module, a method of the
twin class. The Pallas entry points the port's kernel wrappers replace under
other names are mapped in ``RENAMED``; a few private solver methods that the
JAX package's own tests call are checked too (``PRIVATE_CHECKED``). What is
left is TPU machinery with no place in the port, in ``ALLOWED``, one reason
an entry; an entry that is no longer a gap fails, so the list stays true.

<1 s of worker time; no JAX.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "iterative_learning_nmpc_tpu")
PORT_PKG = os.path.join(ROOT, "iterative_learning_nmpc_tpu_torch")

RENAMED_MODULES = {
    "ops/dynjac_kernel.py": "ops/dyncore.py ops/dynjac.py ops/lingram.py",
    "ops/riccati_kernel.py": "ops/riccati.py",
    "ops/policy_kernel.py": "ops/policy_pd.py",
    "sim/jax_sim.py": "sim/device_sim.py",
}

# (JAX module, JAX name) -> the port's name for it (the kernel wrappers)
RENAMED = {
    ("ops/dynjac_kernel.py", "dyncore_pallas"): "dyncore",
    ("ops/dynjac_kernel.py", "dynjac_pallas"): "dynjac",
    ("ops/dynjac_kernel.py", "lingram_lane_major"): "lingram",
    ("ops/riccati_kernel.py", "riccati_rollout_lane_major"): "riccati_rollout",
    ("ops/riccati_kernel.py", "riccati_pallas_lane_major"): "riccati_sweep_terminal",
    ("ops/riccati_kernel.py", "riccati_pallas_batched"): "riccati_sweep",
    ("ops/riccati_kernel.py", "make_riccati_pallas"): "riccati_sweep",
    ("ops/riccati_kernel.py", "forward_rollout_lane_major"): "forward_rollout",
    ("ops/riccati_kernel.py", "fused_rollout_max_n"): "FUSED_ROLLOUT_MAX_N",
    ("ops/policy_kernel.py", "policy_pd_reference"): "policy_pd_plain",
}

# private names the JAX package's tests call, checked like public ones
PRIVATE_CHECKED = {
    "solver/sqp.py": ("TrajOptSolver._ineq_g", "TrajOptSolver._dual_g",
                      "TrajOptSolver._total_cost"),
}

_DUAL = ("the forward-mode dual number of the Pallas kernel body (the CUDA "
         "kernels carry it as legdyn.cuh's Dual)")
ALLOWED = {
    ("ops/dynjac_kernel.py", "D"): _DUAL,
    **{("ops/dynjac_kernel.py", n): f"a helper on {_DUAL}" for n in (
        "dsin", "dcos", "vadd", "vsub", "vscale", "cross", "matvec", "matTvec", "matmat",
        "const_vec", "const_mat", "rodrigues", "ypr_matrix", "euler_rate_matrix",
        "euler_rate_matrix_dot", "fk_feet_dual")},
}


def _defs(path):
    """{name: None (function), "name" (a module-level assignment) or the
    set of a class's method names} of a module's top level."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            out[node.name] = {b.name for b in node.body
                              if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, "name")
    return out


def _jax_modules():
    mods = []
    for root, _, files in os.walk(JAX_PKG):
        mods += [os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")
                 for f in files if f.endswith(".py")]
    return sorted(mods)


def _port_defs(rel):
    out = {}
    for twin in RENAMED_MODULES.get(rel, rel).split():
        path = os.path.join(PORT_PKG, twin)
        assert os.path.exists(path), f"{rel}: the port has no {twin}"
        out.update(_defs(path))
    return out


def _wanted(rel):
    """The JAX module's names the port must have: 'f' or 'C.m'."""
    names = []
    for name, kind in _defs(os.path.join(JAX_PKG, rel)).items():
        if name.startswith("_") or kind == "name":
            continue
        names.append(name)
        if isinstance(kind, set):
            names += [f"{name}.{m}" for m in sorted(kind) if not m.startswith("_")]
    return names + list(PRIVATE_CHECKED.get(rel, ()))


def _has(port, rel, name):
    name = RENAMED.get((rel, name), name)
    cls, _, meth = name.partition(".")
    if not meth:
        return cls in port
    return isinstance(port.get(cls), set) and meth in port[cls]


def _gaps(rel):
    port = _port_defs(rel)
    return [n for n in _wanted(rel) if not _has(port, rel, n)]


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    missing = [n for n in _gaps(rel) if (rel, n) not in ALLOWED]
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_allow_list_holds_only_gaps():
    """Each allowed name exists in the JAX package, is missing from the port
    and has a reason."""
    for (rel, name), reason in ALLOWED.items():
        assert reason, (rel, name)
        assert name in _wanted(rel), f"{rel}:{name} is not a public JAX name"
        assert name in _gaps(rel), f"{rel}:{name} has a counterpart now: drop it"


def test_renamed_targets_exist():
    for (rel, name), target in RENAMED.items():
        assert name in _wanted(rel), f"{rel}:{name} is not a public JAX name"
        assert target in _port_defs(rel), f"{rel}: the port has no {target}"


def test_audited_names_present():
    """The names the port lacked before its twentieth slice, by module."""
    audited = {
        "solver/linearize.py": ("linearize_stages_dynjac", "lingram_stages_dynjac",
                                "total_cost_dyncore", "eq_residuals_dyncore", "ineq_g_dyncore",
                                "dual_g_dyncore", "cost_dual_dyncore"),
        "solver/sqp.py": ("Solution.q", "Solution.v", "Solution.a", "Solution.f",
                          "TrajOptSolver.update_ineq_multipliers", "TrajOptSolver.set_max_iter",
                          "TrajOptSolver.set_nlp_tol", "TrajOptSolver.set_qp_tol",
                          "TrajOptSolver._ineq_g", "TrajOptSolver._dual_g",
                          "TrajOptSolver._total_cost"),
        "ocp/problem.py": ("stage_residual_from_params",),
        "gait/planner.py": ("GaitPlanner.window_device",),
        "learning/network.py": ("make_policy_apply",),
        "robots/spec.py": ("RobotSpec.n_foot", "RobotSpec.ancestor_mask",
                           "RobotSpec.total_mass"),
        "models/math3d.py": ("rot_x", "rot_y", "rot_z"),
        "models/transforms.py": ("v_global_to_local",),
    }
    for rel, names in audited.items():
        port = _port_defs(rel)
        for n in names:
            assert _has(port, rel, n), f"{rel}: {n}"
