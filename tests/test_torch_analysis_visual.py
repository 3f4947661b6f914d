"""The port's offline diagnostics (``learning/analysis.py``) and scene
overlays (``sim/visual.py``) against the JAX package's, on the CPU.

The numeric functions give equal arrays on the same seeded data; each
figure builder draws the same axes (titles, labels, the lines' and
collections' data, bars) as the JAX one; ``MPCVisualCallback`` adds the
same ``mjvGeom`` markers (type, size, position, frame, colour) to an
``MjvScene`` as the JAX callback, for a plain and a combined controller and
a wrench on the trunk. No JAX compile; ~6 s of worker time (matplotlib).
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import mujoco  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from iterative_learning_nmpc_tpu.learning import analysis as jan  # noqa: E402
from iterative_learning_nmpc_tpu.sim import visual as jvis  # noqa: E402
from iterative_learning_nmpc_tpu_torch.learning import analysis as tan  # noqa: E402
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec  # noqa: E402
from iterative_learning_nmpc_tpu_torch.sim import visual as tvis  # noqa: E402
from iterative_learning_nmpc_tpu_torch.sim.mujoco_sim import Simulator  # noqa: E402


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = 300
    return dict(
        states=rng.normal(size=(n, 44)), states2=rng.normal(1.0, 2.0, size=(n // 2, 44)),
        actions=rng.normal(size=(n, 12)), t=np.arange(n) * 1e-3,
        v=rng.normal(size=(n, 3)), goal=np.tile([0.3, 0.0, 0.0], (n, 1)),
        feet=rng.normal(size=(n, 12)), expert=(rng.uniform(size=n) > 0.6),
        nom_t=np.arange(n)[::-1] * 1e-3, nom=rng.normal(size=(n, 44)),
        jl=np.stack([-np.ones(12), np.ones(12)], 1))


def test_numeric_functions_match_jax(data):
    d = data
    for a, b in zip(tan.pca(d["states"], 3), jan.pca(d["states"], 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tan.velocity_goal_error(d["v"], d["goal"]),
                    jan.velocity_goal_error(d["v"], d["goal"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tan.perturbed_vs_nominal_distance(d["states"], d["t"], d["nom"], d["nom_t"]),
        jan.perturbed_vs_nominal_distance(d["states"], d["t"], d["nom"], d["nom_t"]))
    np.testing.assert_array_equal(tan.butterworth_lowpass(d["states"][:, :5], 7.0),
                                  jan.butterworth_lowpass(d["states"][:, :5], 7.0))
    for a, b in zip(tan.action_bounds(d["actions"]), jan.action_bounds(d["actions"])):
        np.testing.assert_array_equal(a, b)
    assert tan.expert_influence_ratio(d["expert"]) == jan.expert_influence_ratio(d["expert"])
    assert tan.expert_influence_ratio([]) == jan.expert_influence_ratio([]) == 0.0


def content(fig):
    """What a figure draws, axis by axis."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            lines=[np.asarray(ln.get_xydata()).tolist() for ln in ax.get_lines()],
            colls=[np.asarray(c.get_offsets()).tolist() for c in ax.collections],
            paths=[[p.vertices.tolist() for p in c.get_paths()] for c in ax.collections],
            bars=[(p.get_x(), p.get_height()) for p in ax.patches]))
    out.append(fig._suptitle.get_text() if fig._suptitle else "")
    return out


BUILDERS = {
    "pca": lambda m, d: m.plot_pca_analysis([d["states"], d["states2"]], ["a", "b"]),
    "dist": lambda m, d: m.plot_dataset_distribution([d["states"], d["states2"]], dims=range(6)),
    "tracking": lambda m, d: m.plot_policy_tracking(d["t"], d["v"], d["goal"]),
    "feet": lambda m, d: m.plot_feet_position(d["t"], d["feet"]),
    "ood": lambda m, d: m.plot_perturbed_vs_nominal(d["t"], d["states"], d["nom_t"], d["nom"]),
    "smooth": lambda m, d: m.plot_smoothing_comparison(d["t"], d["states"][:, 1:5], dims=[0, 2]),
    "actions": lambda m, d: m.plot_action_bounds(d["actions"], d["jl"]),
    "expert": lambda m, d: m.plot_expert_segments(d["t"], d["expert"]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_figures_match_jax(data, name, tmp_path):
    ft, fj = BUILDERS[name](tan, data), BUILDERS[name](jan, data)
    try:
        assert content(ft) == content(fj)
    finally:
        plt.close(ft)
        plt.close(fj)


class FakeMPC:
    def __init__(self):
        self._last_base_ref = np.array([0.1, 0.0, 0.3] + [0.0] * 9)
        self._last_base_ref_e = np.array([0.4, 0.05, 0.3] + [0.0] * 9)
        loc = np.zeros((4, 26, 3))
        loc[0, 3:] = [0.2, 0.15, 0.02]
        loc[2, 0:] = [-0.2, 0.15, 0.02]
        self._last_cnt_loc = loc


class FakeCombined:
    mpc_active = True


def geoms(scene):
    return [(int(g.type), np.asarray(g.size).tolist(), np.asarray(g.pos).tolist(),
             np.asarray(g.mat).tolist(), np.asarray(g.rgba).tolist())
            for g in scene.geoms[: scene.ngeom]]


@pytest.mark.parametrize("combined", [False, True])
def test_mpc_visual_callback_geoms_match_jax(combined):
    sim = Simulator(go2_spec(device="cpu"))
    sim.data.xfrc_applied[sim.trunk_body][:3] = [30.0, -10.0, 5.0]
    mpc, comb = FakeMPC(), (FakeCombined() if combined else None)
    scenes = []
    for mod in (tvis, jvis):
        scene = mujoco.MjvScene(sim.model, maxgeom=50)
        mod.MPCVisualCallback(mpc, comb, trunk_body=sim.trunk_body).render(scene, sim.data)
        scenes.append(scene)
    assert scenes[0].ngeom == scenes[1].ngeom == 5 + int(combined)
    assert geoms(scenes[0]) == geoms(scenes[1])
    # a full scene takes no more markers
    full = mujoco.MjvScene(sim.model, maxgeom=2)
    tvis.MPCVisualCallback(mpc, comb, trunk_body=sim.trunk_body).render(full, sim.data)
    assert full.ngeom == 2
