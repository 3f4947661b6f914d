"""``sim/device_sim.graphed`` on the card: a CUDA graph of the device plant
step replays the eager step bit for bit.

Marked ``cuda``: skipped where no CUDA device is present. This file imports
no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -q -s -m cuda tests/test_torch_cuda_graphed.py

The step (B=1, as ``chip_smoke.py``'s ``PlantGraph`` and the warm starts
capture it) is captured four ways, returning the state alone or with the
feet's world points, each at the zero chart state and at the settled
standing state, and twice more from a function whose contact parameters
nothing else holds: as ``graphed`` returns it (the returned function holds
``fn``, and so the parameters) and with that reference dropped (the
parameters' memory goes back to the allocator). Each replay is compared
with the eager step on random near-standing inputs (state noise 0.01,
torques ~ N(0, 5), a trunk force ~ N(0, 10)) and over 100 steps of a
standing PD loop. Every graph that holds what it reads must give the eager
steps exactly; the dropped one's gap is printed (what it reads depends on
the allocator), the demonstration of why ``graphed`` holds ``fn``.
Without a card every test here skips: no worker time.
"""
import numpy as np
import pytest
import torch

N_INPUTS, N_STEPS = 5, 100


@pytest.fixture(scope="module")
def plant():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from iterative_learning_nmpc_tpu_torch.models.dynamics import foot_positions, settled_state
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    dev = torch.device("cuda")
    spec = go2_spec(device=dev)
    cp = device_sim.contact_params_for(spec, device=dev)
    t = torch.zeros(1, device=dev)

    def state_step(q, v, t, tau, f):
        return tuple(device_sim.step(spec, device_sim.SimState(q, v, t), tau, cp, 1e-3,
                                     f_ext=f))

    def step(q, v, t, tau, f):
        q, v, t = state_step(q, v, t, tau, f)
        return q, v, t, foot_positions(spec, q).reshape(1, 12)

    x0 = settled_state(spec.to("cpu"))
    xs = torch.as_tensor(x0, device=dev)[None]
    z = lambda n: torch.zeros(1, n, device=dev)
    standing = (xs[:, :18].contiguous(), xs[:, 18:].contiguous(), t, z(12), z(3))
    graphs = {}
    for out, fn in (("state", state_step), ("state and feet", step)):
        graphs[f"{out}, zero state"] = device_sim.graphed(fn, z(18), z(18), t, z(12), z(3))
        graphs[f"{out}, standing state"] = device_sim.graphed(fn, *standing)

    def closure_graph(keep):
        own = device_sim.contact_params_for(spec, device=dev)     # only fn holds it

        def fn(q, v, t, tau, f):
            return tuple(device_sim.step(spec, device_sim.SimState(q, v, t), tau, own, 1e-3,
                                         f_ext=f))

        run = device_sim.graphed(fn, *standing)
        if not keep:
            del run.fn
        return run

    graphs["closure-held parameters, fn kept"] = closure_graph(True)
    dropped = closure_graph(False)

    def call(run, x):
        d = torch.as_tensor(x).to(dev)
        q, v = run(d[None, :18], d[None, 18:36], t, d[None, 36:48], d[None, 48:])[:2]
        return torch.cat([q, v], -1)[0].cpu().numpy()

    return dict(x0=x0, step=step, graphs=graphs, dropped=dropped, call=call)


def inputs(x0):
    rng = np.random.default_rng(0)
    return [np.concatenate([x0 + rng.normal(0, 0.01, 36), rng.normal(0, 5, 12),
                            rng.normal(0, 10, 3)]).astype(np.float32) for _ in range(N_INPUTS)]


def pd_loop(call, run, x0):
    x = x0.copy()
    for _ in range(N_STEPS):
        tau = 20 * (x0[6:18] - x[6:18]) - 1.5 * x[24:36]
        x = call(run, np.concatenate([x[:36], tau, np.zeros(3)]).astype(np.float32))
    return x


@pytest.mark.cuda
def test_graphed_plant_step_equals_the_eager_step(plant):
    call, step = plant["call"], plant["step"]
    xs = inputs(plant["x0"])
    eager = [call(step, x) for x in xs]
    ref = pd_loop(call, step, plant["x0"])
    for name, run in plant["graphs"].items():
        gaps = [float(np.abs(call(run, x) - e).max()) for x, e in zip(xs, eager)]
        loop = pd_loop(call, run, plant["x0"])
        print(f"[graphed] {name}: max |replay - eager| per input {gaps}; after {N_STEPS} "
              f"PD steps base z {loop[2]:.7g} (eager {ref[2]:.7g})")
        assert max(gaps) == 0.0 and np.array_equal(loop, ref), name
    gaps = [float(np.abs(call(plant["dropped"], x) - e).max()) for x, e in zip(xs, eager)]
    loop = pd_loop(call, plant["dropped"], plant["x0"])
    print(f"[graphed] closure-held parameters, fn dropped: max |replay - eager| per input "
          f"{gaps}; after {N_STEPS} PD steps base z {loop[2]:.7g} (eager {ref[2]:.7g}) "
          f"({torch.cuda.get_device_name(0)})")
