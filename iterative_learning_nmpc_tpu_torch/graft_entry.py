"""Entry points of the port, the counterparts of the JAX package's root
``__graft_entry__.py``.

- ``entry()``: one RTI iteration of the Go2 trot NMPC (solve + the
  solution's cost) on the flagship instance, one card.
- ``dryrun_multichip(n)``: ONE full framework iteration sharded over the
  ``n`` ranks of the process group (``parallel.mesh``): a dp-sharded batch
  of NMPC solves against the unsharded solve, a data-parallel policy
  training step with all-reduced gradients, and a sharded on-device
  SafeDAgger data step on randomized plants against the unsharded one,
  aggregated by ``all_gather_dataset`` and ``expert_ratio_psum``.

Run ``dryrun_multichip(n)`` in each of ``n`` processes joined by
``parallel.launcher.launch_distributed`` (NCCL on the cards, gloo on the
CPU); with no process group, ``n`` is 1.

    python -m iterative_learning_nmpc_tpu_torch.graft_entry
"""
from __future__ import annotations

import numpy as np
import torch

from .flagship import flagship, perturbed_batch
from .learning.network import init_network
from .learning.ondevice import make_batched_mpc_rollout
from .learning.randomize import randomize_payload, randomize_terrain, sample_force_windows
from .models.dynamics import settled_state
from .parallel.mesh import (
    all_gather_dataset,
    expert_ratio_psum,
    local_slice,
    make_batch_solver,
    make_mesh,
    make_train_step_dp,
    shard_batch,
    shard_by_batch,
)
from .robots.go2 import go2_spec


def entry(device=None):
    """Returns (fn, example_args): one RTI NMPC iteration on the flagship
    problem, on ``device`` (by default the card)."""
    solver, X, U, params = flagship(device=device)

    def step(X, U, params):
        sol = solver.solve(X, U, params, n_iter=1)
        return sol.X, sol.U, sol.stats.cost

    return step, (X, U, params)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one sharded framework step over the ``n_devices`` ranks and
    hold it to the unsharded computation with the JAX dryrun's gates.
    Returns the three stages' numbers (identical on every rank)."""
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    gmax = lambda t: float(all_gather_dataset(mesh, t.reshape(1, -1)).amax())
    out_numbers = {"world_size": mesh.size, "backend": (
        torch.distributed.get_backend(mesh.group) if mesh.group is not None else "none")}

    # --- dp-sharded batch of NMPC solves at the flagship OCP shape (N=25),
    #     against the unsharded solve of the whole batch ---
    solver, X, U, params = flagship(device=dev)
    B = n_devices * 2
    Xb, Ub, pb = perturbed_batch(X, U, params, B, seed=0)
    ref = solver.solve(Xb, Ub, pb, 1)
    rows = local_slice(mesh, B)
    Xs, Us, ps = (shard_batch(mesh, t) for t in (Xb, Ub, pb))
    sol = make_batch_solver(solver, n_iter=1)(Xs, Us, ps)
    _check(sol.X.shape == (B // mesh.size,) + X.shape[1:], f"shard shape {sol.X.shape}")
    max_dx = gmax((sol.X - ref.X[rows]).abs().amax())
    _check(max_dx <= 1e-4, f"sharded != unsharded solve: {max_dx:.2e}")
    cost = float(all_gather_dataset(mesh, sol.stats.cost).mean())
    print(f"[dryrun] batched solve OK on {n_devices} devices (N={solver.N}), "
          f"mean cost {cost:.2f}, sharded-vs-unsharded max|dX| {max_dx:.2e}", flush=True)
    out_numbers.update(solve_max_dx=max_dx, solve_mean_cost=cost)

    # --- data-parallel policy train step (replicated params, averaged grads) ---
    gen = lambda s: torch.Generator().manual_seed(s)
    net = init_network(47, 12, num_hidden_layer=2, hidden_dim=64, generator=gen(0), device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    train_step = make_train_step_dp(net, opt, mesh)
    xb = shard_batch(mesh, torch.ones(n_devices * 8, 47))
    yb = shard_batch(mesh, torch.zeros(n_devices * 8, 12))
    loss = float(train_step(xb, yb))
    _check(np.isfinite(loss), f"dp train step loss {loss}")
    print(f"[dryrun] dp train step OK, loss {loss:.4f}", flush=True)
    out_numbers["train_loss"] = loss

    # --- the on-device SafeDAgger data step on randomized plants, sharded,
    #     against the unsharded step, aggregated over the ranks ---
    spec = go2_spec(device=dev)
    net_s = init_network(47, 12, num_hidden_layer=2, hidden_dim=64, generator=gen(0),
                         device=dev).eval()
    norm = (np.zeros(44, np.float32), np.ones(44, np.float32),
            np.zeros(3, np.float32), np.ones(3, np.float32))
    n_intervals, B2 = 2, n_devices * 2
    rollout = make_batched_mpc_rollout(spec, n_intervals=n_intervals, policy=(net_s, norm),
                                       delay_steps=5, mpc_min_steps=10, device=dev)
    x0b = np.tile(settled_state(spec)[None], (B2, 1))
    x0b[:, 6:18] += 0.02 * torch.randn(B2, 12, generator=gen(1)).numpy()
    vdes = np.zeros((B2, 3), np.float32)
    vdes[:, 0] = 0.2
    ps = randomize_payload(spec, gen(2), B2)
    tr = randomize_terrain(gen(3), B2, device=dev)
    fw = sample_force_windows(gen(4), B2, n_intervals * 40, device=dev)
    ref = rollout(x0b, vdes, ps, tr, force_windows=fw)

    # explicit placement: the payload spec marked True slices ONLY mass and
    # com; its other fields are constants (e.g. joint_pos (18, 3)) that
    # shape inference would slice whenever B2 == 18
    args = shard_by_batch(mesh, (x0b, vdes, ps, tr, fw), B2,
                          batched=(True, True, True, True, True))
    out = rollout(*args[:4], force_windows=args[4])
    # Sharded-vs-unsharded standard for a CLOSED-LOOP CONTACT rollout (the
    # JAX dryrun's): batches of other sizes round differently, and the
    # differences grow through contact impacts, so (a) agreement on the
    # 5-step prefix, (b) a bounded envelope through the first replanning
    # interval, (c) the aggregate statistics within 0.02
    derr = all_gather_dataset(
        mesh, (out.state44 - ref.state44[rows]).abs().amax(dim=(0, 2))[None]).amax(0)
    dq5, d10, d15 = (float(derr[:k].max()) for k in (5, 10, 15))
    _check(dq5 <= 1e-5, f"sharded != unsharded DAgger prefix: {dq5:.2e}")
    _check(d10 <= 0.1, f"first-interval envelope (10 steps): {d10:.2e}")
    _check(d15 <= 1.0, f"first-interval envelope (15 steps): {d15:.2e}")
    exp_all = all_gather_dataset(mesh, out.is_expert)
    r_sh, r_ref = float(exp_all.mean()), float(ref.is_expert.mean())
    v_sh = float(all_gather_dataset(mesh, out.valid).mean())
    v_ref = float(ref.valid.mean())
    _check(abs(r_sh - r_ref) <= 0.02, f"expert ratio {r_sh} vs {r_ref}")
    _check(abs(v_sh - v_ref) <= 0.02, f"valid share {v_sh} vs {v_ref}")
    _check(bool(torch.isfinite(out.state44).all()), "non-finite rows")
    gathered = all_gather_dataset(mesh, out.state44.reshape(out.state44.shape[0], -1))
    _check(gathered.shape[0] == B2, f"gathered rows {tuple(gathered.shape)}")
    ratio = expert_ratio_psum(mesh, out.is_expert)
    _check(abs(ratio - r_sh) <= 1e-5, f"psum'd expert ratio {ratio} vs {r_sh}")
    print(f"[dryrun] sharded DAgger data step OK on {n_devices} devices "
          f"(B={B2}, {n_intervals} intervals): sharded-vs-unsharded 5-step-prefix "
          f"max|d| {dq5:.2e} (10 steps {d10:.2e}, 15 steps {d15:.2e}), expert ratio "
          f"{ratio:.3f} (unsharded {r_ref:.3f}), valid {v_sh:.3f} (unsharded "
          f"{v_ref:.3f}), gathered rows {tuple(gathered.shape)}", flush=True)
    out_numbers.update(dagger_d5=dq5, dagger_d10=d10, dagger_d15=d15, expert_ratio=ratio,
                       expert_ratio_unsharded=r_ref, valid=v_sh, valid_unsharded=v_ref,
                       gathered_rows=list(gathered.shape))
    return out_numbers


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() OK, cost:", float(out[2][0]))
