"""The port's footstep planners against the JAX package's, on the CPU.

Both are numpy host code in float64: ``get_make_break_contacts``,
``RaibertContactPlanner`` (with and without its cache, over a replan
sequence that moves the state and drops old footsteps),
``CustomContactPlanner`` and ``AcyclicContactPlanner`` are held to the JAX
planners on the same inputs, to 1e-12, and to the gates of the JAX
package's planner tests (tests/test_gait_and_variants.py). No JAX
computation runs: ~1 s of worker time.
"""
import numpy as np
import pytest

from iterative_learning_nmpc_tpu.gait import planner as jp
from iterative_learning_nmpc_tpu.mpc.config import GAITS as JAX_GAITS
from iterative_learning_nmpc_tpu_torch.gait import planner as tp
from iterative_learning_nmpc_tpu_torch.mpc.config import GAITS

FEET = ["FL", "FR", "RL", "RR"]
HIPS = np.array([[0.19, 0.14, 0], [0.19, -0.14, 0], [-0.19, 0.14, 0], [-0.19, -0.14, 0]])
TOL = 1e-12


@pytest.mark.parametrize("gait", sorted(GAITS))
def test_make_break_contacts_match_jax(gait):
    a = tp.ContactPlanner(FEET, 0.04, GAITS[gait])
    b = jp.ContactPlanner(FEET, 0.04, JAX_GAITS[gait])
    np.testing.assert_array_equal(a.switch_cnt, b.switch_cnt)
    for node in (0, 3, 11, 40):
        for x, y in zip(a.get_make_break_contacts(node, 26), b.get_make_break_contacts(node, 26)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cache_cnt", [True, False])
def test_raibert_replan_sequence_matches_jax(cache_cnt):
    """Twelve replans, one node apart, with the state moving, a yaw rate and
    a sideways command; the cache dropped before every fourth."""
    kw = dict(offset_hip_b=HIPS, x_offset=0.04, y_offset=0.02, foot_size=0.0085,
              height_offset=0.01, cache_cnt=cache_cnt)
    a = tp.RaibertContactPlanner(FEET, 0.04, GAITS["trot"], **kw)
    b = jp.RaibertContactPlanner(FEET, 0.04, JAX_GAITS["trot"], **kw)
    np.testing.assert_array_equal(a.offset_hip_b, b.offset_hip_b)
    rng = np.random.default_rng(0)
    for i in range(12):
        state = dict(pos=rng.normal(0, 0.1, 3), v_w=rng.normal(0, 0.2, 3),
                     ypr=rng.normal(0, 0.3, 3), com_xyz=np.array([0.1 * i, 0.02, 0.28]),
                     v_des=np.array([0.4, 0.1, 0.0]), w_yaw=0.3)
        for p in (a, b):
            if i % 4 == 3:
                p.remove_cnt_before(i)
            p.set_state(**state)
        la, lb = a.get_locations(i, 26), b.get_locations(i, 26)
        assert la.shape == (4, 26, 3)
        np.testing.assert_allclose(la, lb, rtol=0, atol=TOL)
    assert {k: sorted(v) for k, v in a.planned_cnt.items()} == {
        k: sorted(v) for k, v in b.planned_cnt.items()}
    if cache_cnt:
        assert any(a.planned_cnt.values())


def test_raibert_planner_gates():
    """The JAX package's test_raibert_locations: footsteps ahead of the
    hips when walking forward, and a replan of the same nodes identical."""
    p = tp.RaibertContactPlanner(FEET, 0.04, GAITS["trot"], offset_hip_b=HIPS,
                                 cache_cnt=True)
    p.set_state(pos=np.zeros(3), v_w=np.zeros(3), ypr=np.zeros(3),
                com_xyz=np.array([0.0, 0.0, 0.3]), v_des=np.array([0.4, 0.0, 0.0]))
    loc = p.get_locations(0, 26)
    placed = loc[np.any(loc != 0, axis=-1)]
    assert len(placed) > 0 and placed[:, 0].max() > 0.19
    np.testing.assert_array_equal(loc, p.get_locations(0, 26))
    with pytest.raises(RuntimeError):
        tp.RaibertContactPlanner(FEET, 0.04, GAITS["trot"], HIPS).get_locations(0, 26)


def test_custom_planner_matches_jax():
    """The JAX package's test_custom_planner on both packages: the table
    repeats its last cycle past the plan, and a periodic sequence replaces
    the gait's."""
    cl = np.tile(np.array([[0.2, 0.1, 0.0]]), (3, 4, 1))
    cl[1, :, 0] = 0.4
    cl[2, :, 1] = -0.3
    a = tp.CustomContactPlanner(FEET, 0.04, GAITS["trot"])
    b = jp.CustomContactPlanner(FEET, 0.04, JAX_GAITS["trot"])
    for p in (a, b):
        p.set_contact_locations(cl)
    for node in (0, 7, 12, 30, 1000):
        np.testing.assert_allclose(a.get_locations(node, 26), b.get_locations(node, 26),
                                   rtol=0, atol=TOL)
    np.testing.assert_array_equal(a.get_locations(1000, 26)[:, -1], cl[-1])
    seq = np.roll(a.gait_sequence, 2, axis=1)
    for p in (a, b):
        p.set_periodic_sequence(seq)
    np.testing.assert_array_equal(a.get_contacts(0, seq.shape[1]), seq)
    np.testing.assert_array_equal(a.get_peaks(5, 26), b.get_peaks(5, 26))
    with pytest.raises(ValueError):
        a.set_contact_locations(np.zeros((3, 4, 2)))
    with pytest.raises(ValueError):
        a.set_periodic_sequence(seq[:, :-1])


def test_acyclic_planner_matches_jax():
    """The JAX package's test_acyclic_planner (the window clamps at the
    last node) on both packages, with patches."""
    seq = np.ones((4, 10), dtype=np.int64)
    seq[:, 4:7] = 0
    rng = np.random.default_rng(1)
    centers, rots, sizes = rng.normal(size=(4, 10, 3)), rng.normal(size=(4, 10)), \
        rng.uniform(0.02, 0.1, (4, 10, 2))
    a, b = tp.AcyclicContactPlanner(), jp.AcyclicContactPlanner()
    with pytest.raises(ValueError):
        a.get_sequence(0, 4)
    for p in (a, b):
        p.set_sequence(seq)
        p.set_center_rot_size(centers, rots, sizes)
    w = a.get_sequence(8, 6)
    np.testing.assert_array_equal(w[:, 2:], 1)
    np.testing.assert_array_equal(a.get_peak(8, 6), 1 - w)
    for node in (0, 3, 8, 20):
        np.testing.assert_array_equal(a.get_sequence(node, 6), b.get_sequence(node, 6))
        for x, y in zip(a.get_center_rot_size_patch(node, 6),
                        b.get_center_rot_size_patch(node, 6)):
            np.testing.assert_array_equal(x, y)
