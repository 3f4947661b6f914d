"""Worker process for tests/test_torch_parallel.py (imports no JAX).

Joins a gloo process group on the CPU through the port's
``parallel.launcher.launch_distributed`` with a localhost coordinator, then
runs on its half of each batch: a psum of arange, ``all_gather_dataset``,
``expert_ratio_psum``, ``make_batch_solver`` at ``flagship(n_nodes=4)``
(B = 4) against the unsharded solve of the whole batch, and one
``make_train_step_dp`` step of the net and batch in ``<case.pkl>``. Writes
its results as a pickle.

    python torch_parallel_worker.py <coordinator> <n_proc> <rank> <case.pkl> <out.pkl> <timeout_s>
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
import torch.distributed as dist


def main():
    coordinator, n_proc, rank, case_path, out_path, timeout = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
        float(sys.argv[6]))
    torch.set_num_threads(1)

    from iterative_learning_nmpc_tpu_torch.flagship import flagship, perturbed_batch
    from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy
    from iterative_learning_nmpc_tpu_torch.parallel.launcher import launch_distributed
    from iterative_learning_nmpc_tpu_torch.parallel.mesh import (
        all_gather_dataset, expert_ratio_psum, local_slice, make_batch_solver, make_mesh,
        make_train_step_dp, shard_batch, shutdown_distributed)

    launch_distributed(coordinator=coordinator, num_processes=n_proc, process_id=rank,
                       device="cpu", timeout=timeout)
    mesh = make_mesh(n_proc, device="cpu")
    res = dict(rank=mesh.rank, size=mesh.size, backend=dist.get_backend())

    # psum of the global arange(4 * n_proc), each rank holding 4 of it
    local = torch.arange(4, dtype=torch.float32) + 4.0 * mesh.rank
    total = local.sum()
    dist.all_reduce(total)
    res["psum"] = float(total)

    rows = torch.arange(32.0).reshape(16, 2)
    res["gathered"] = all_gather_dataset(mesh, shard_batch(mesh, rows)).numpy()
    mask = np.zeros(16, np.float32)
    mask[:4] = 1.0                       # every expert row on rank 0
    res["ratio"] = expert_ratio_psum(mesh, shard_batch(mesh, mask))

    # the dp-sharded solve against the unsharded one of the whole batch
    solver, X, U, params = flagship(device="cpu", n_nodes=4)
    Xb, Ub, pb = perturbed_batch(X, U, params, 4, seed=1)
    ref = solver.solve(Xb, Ub, pb, 1)
    sol = make_batch_solver(solver, n_iter=1)(*(shard_batch(mesh, t) for t in (Xb, Ub, pb)))
    sl = local_slice(mesh, 4)
    res["solve_rows"] = sol.X.shape[0]
    res["max_dx"] = float(all_gather_dataset(
        mesh, (sol.X - ref.X[sl]).abs().amax().reshape(1, 1)).max())

    # one data-parallel train step on the case's net and batch
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    net, _ = policy_from_numpy(case["payload"], device="cpu")
    opt = torch.optim.Adam(net.parameters(), lr=case["lr"], betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step_dp(net, opt, mesh)
    loss = step(shard_batch(mesh, torch.as_tensor(case["x"])),
                shard_batch(mesh, torch.as_tensor(case["y"])))
    res["loss"] = float(loss)
    res["variables"] = net.flax_variables()

    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    shutdown_distributed()
    print(f"[worker {rank}] psum {res['psum']} ratio {res['ratio']} max_dx {res['max_dx']:.2e} "
          f"loss {res['loss']:.6f}", flush=True)


if __name__ == "__main__":
    main()
