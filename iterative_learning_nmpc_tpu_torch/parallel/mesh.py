"""Data parallelism over ranks for batched solves, policy training and
dataset aggregation, on ``torch.distributed``.

Counterpart of ``iterative_learning_nmpc_tpu/parallel/mesh.py``. Where the
JAX package shards a batch over the devices of a ``jax.sharding.Mesh``
inside one program, the port runs one process (rank) per card, joined in
one process group: NCCL between CUDA devices, gloo on the CPU
(``initialize_distributed``). Each rank holds the slice of the batch's
leading axis that its position gives it (``shard_batch``,
``shard_by_batch``) and everything else whole:

- **dp solves** (``make_batch_solver``): each rank solves its slice with
  ``TrajOptSolver.solve``; the problems are independent, so no collective
  runs;
- **dp training** (``make_train_step_dp``): the JAX package's ``pmean``
  semantics, per-shard L1 loss and BatchNorm statistics, the loss, the
  gradients and the running statistics averaged by ``all_reduce``;
- **aggregation** (``all_gather_dataset``, ``expert_ratio_psum``).

One process without a process group is a mesh of one rank, on which every
collective is the identity. Inside a group, also one of size 1, every
collective runs through the group's backend.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..robots.spec import RobotSpec

# seconds a rank waits for the others at the rendezvous and in a collective
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data-parallel axis over the ranks of the default process group
    (``group`` None: one process without a group)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' buffers live: the card for NCCL, the CPU
        for gloo."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The device of a rank: ``device`` as given, a CUDA device without an
    index made the rank's local card (``LOCAL_RANK``, else the rank modulo
    the cards); by default the card (``device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or dev.index is None):
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        dev = torch.device("cuda", local)
    return dev


def init_process_group(coordinator: str, num_processes: int, process_id: int,
                       device=None, timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group at ``coordinator`` ("host:port",
    rank 0 listens there): NCCL when the rank's device is a CUDA device,
    gloo on the CPU. A rank that cannot rendezvous within ``timeout``
    seconds raises. Returns the rank's device."""
    if coordinator is None:
        raise ValueError("a process group needs its coordinator address (host:port)")
    dev = rank_device(device, process_id)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None,
                           timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Multi-process bring-up (a no-op for one process): see
    ``init_process_group``."""
    if num_processes is None or num_processes <= 1:
        return
    init_process_group(coordinator, num_processes, process_id, device, timeout)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the default process group, one rank per card, or of
    this process alone when no group was joined. ``n_devices``, when given,
    must be the number of ranks."""
    if dist.is_initialized():
        rank, size, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, size, group = 0, 1, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks, one a "
                         f"card; this process group has {size}")
    return Mesh(rank, size, rank_device(device, rank), group)


def local_slice(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``, split evenly in rank order."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not split over {mesh.size} ranks")
    n = batch // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _tree_map(fn, tree, spec_leaf: bool = False):
    """``fn`` on every tensor or array of a nest of tuples, named tuples,
    lists, dicts and dataclasses (on every ``RobotSpec`` whole when
    ``spec_leaf``); other leaves as they are."""
    if _is_array(tree) or (spec_leaf and isinstance(tree, RobotSpec)):
        return fn(tree)
    rec = lambda x: _tree_map(fn, x, spec_leaf)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(rec, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(rec, tree))
    if isinstance(tree, dict):
        return {k: rec(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: rec(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _place(mesh: Mesh, x, rows=None):
    """``x`` on the rank's device, its ``rows`` alone when given; a payload
    ``RobotSpec`` is sliced on its batched fields only."""
    if isinstance(x, RobotSpec):
        return (x.take(rows) if rows is not None and x.batch_shape else x).to(mesh.device)
    t = torch.as_tensor(x).to(mesh.device)
    return t if rows is None else t[rows]


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of the leading axis of every tensor in ``tree``,
    on the rank's device; a payload ``RobotSpec`` is sliced on its batched
    fields only (``RobotSpec.batched_fields``)."""
    def place(x):
        batch = x.batch_shape[0] if isinstance(x, RobotSpec) and x.batch_shape else None
        batch = x.shape[0] if _is_array(x) else batch
        return _place(mesh, x, None if batch is None else local_slice(mesh, batch))

    return _tree_map(place, tree, spec_leaf=True)


def shard_by_batch(mesh: Mesh, tree, batch: int, batched=None):
    """Slice the leaves whose LEADING axis is the batch to this rank and
    keep everything else whole, on the rank's device: the placement rule
    for the DAgger data step's mixed inputs (per-env x0, v_des, terrain
    and force windows slice; the nominal spec leaves and policy weights do
    not).

    ``batched`` (recommended): a prefix of ``tree`` of bools marking which
    subtrees are batch-leading. It is explicit placement, which cannot
    misfire when a whole leaf happens to have shape[0] == batch (e.g. a
    ``batch``-wide weight matrix). A ``RobotSpec`` marked True slices its
    batched fields only (``RobotSpec.batched_fields``). When omitted, the
    rule falls back to inferring from shape[0] == batch, which misfires in
    just that case (a spec's (18, 3) ``joint_pos`` at batch 18)."""
    rows = local_slice(mesh, batch)

    if batched is None:
        return _tree_map(lambda x: _place(mesh, x, rows if x.ndim >= 1 and x.shape[0] == batch
                                          else None), tree)

    def marked(flag, sub):
        if isinstance(flag, bool):
            return _tree_map(lambda x: _place(mesh, x, rows if flag else None), sub,
                             spec_leaf=True)
        if isinstance(sub, dict):
            return {k: marked(flag[k], v) for k, v in sub.items()}
        if isinstance(sub, (tuple, list)):
            out = [marked(f, x) for f, x in zip(flag, sub)]
            return type(sub)(*out) if hasattr(sub, "_fields") else type(sub)(out)
        return sub

    return marked(batched, tree)


def make_batch_solver(solver, n_iter: int):
    """fn(X, U, params) -> Solution: this rank's slice of a batched NMPC
    solve (``shard_batch``'s inputs), ``n_iter`` SQP iterations of
    ``solver.solve``. The problems are independent: no collective runs, and
    ``all_gather_dataset`` collects any field of the result."""
    def solve_batch(X, U, params):
        return solver.solve(X, U, params, n_iter)

    return solve_batch


def _all_reduce_mean(mesh: Mesh, tensors) -> None:
    """Replace each tensor by its mean over the ranks, in place (one
    flattened all_reduce)."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors]).to(mesh.comm_device)
    dist.all_reduce(flat, group=mesh.group)
    flat = (flat / mesh.size).to(tensors[0].device)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def make_train_step_dp(net, opt, mesh: Mesh):
    """The data-parallel BC train step with explicit collectives: fn(x, y)
    on this rank's shard of the batch -> the loss averaged over the ranks.

    Per shard: the L1 loss mean(|net(x) - y|) in training mode (BatchNorm
    on the shard's statistics, whose running averages move with them),
    its gradients; then the loss, the gradients and the BatchNorm running
    statistics averaged over the ranks (the JAX step's ``pmean``; not
    ``DistributedDataParallel``, which broadcasts rank 0's buffers), and
    one ``opt`` step on the averaged gradients, the same on every rank.
    The parameters and buffers start as rank 0's (replicated, as the JAX
    step's ``P()`` inputs are)."""
    stats = [b for name, b in net.named_buffers() if name.endswith(("running_mean",
                                                                     "running_var"))]
    if mesh.group is not None:
        for t in list(net.parameters()) + list(net.buffers()):
            buf = t.detach().to(mesh.comm_device)
            dist.broadcast(buf, 0, group=mesh.group)
            with torch.no_grad():
                t.copy_(buf.to(t.device))

    def step(x, y):
        net.train()
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(torch.abs(net(x) - y))
        loss.backward()
        loss = loss.detach().reshape(1).clone()
        params = [p for p in net.parameters() if p.grad is not None]
        with torch.no_grad():
            _all_reduce_mean(mesh, [p.grad for p in params] + stats + [loss])
        opt.step()
        return loss[0]

    return step


def all_gather_dataset(mesh: Mesh, local_rows) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order on every rank (DAgger
    aggregation); each rank gives the same number of rows."""
    x = torch.as_tensor(local_rows).to(mesh.device)
    if mesh.group is None:
        return x
    buf = x.contiguous().to(mesh.comm_device)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def expert_ratio_psum(mesh: Mesh, is_expert_local) -> float:
    """The expert-influence ratio over every rank's rows: the sum of the
    masks over the sum of their sizes, each reduced by an all_reduce
    (reference metric at ``data_collection_locosafedagger.py:219-223``)."""
    m = torch.as_tensor(is_expert_local).to(mesh.device)
    s = torch.stack([m.sum(dtype=torch.float64),
                     torch.tensor(float(m.numel()), dtype=torch.float64, device=m.device)])
    if mesh.group is not None:
        s = s.to(mesh.comm_device)
        dist.all_reduce(s, group=mesh.group)
    return float(s[0] / s[1])


def shutdown_distributed() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
