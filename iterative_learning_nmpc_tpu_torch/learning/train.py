"""The behaviour-cloning trainer: ``GoalConditionedPolicyNet`` + Adam + L1
loss, on the card unless the caller names a device.

Counterpart of ``iterative_learning_nmpc_tpu/learning/train.py``, step for
step: L1 loss mean(|out - y|); Adam with betas (0.9, 0.999) and eps 1e-8
(optax.adam's update); a 90/10 split drawn from
``np.random.default_rng(cfg.seed)``, then one ``rng.choice`` an epoch, for
all its batches, from the same generator (out-of-distribution rows drawn
``ood_weight`` times as often), so that the batches are index for index the
JAX trainer's; warm starts take the architecture from the loaded
payload; checkpoints every ``ckpt_every`` epochs and at the last, and a
final payload carrying the database's normalisation statistics.

X and Y go to the device once. Each epoch's batches are gathered there
from one index array, the per-step losses stay there, and the host reads
them once an epoch: the counterpart of the JAX package's one ``lax.scan``
an epoch. The forward and backward passes are ``nn.Linear`` on cuBLAS (the
JAX package trains with Flax ``Dense`` under XLA, outside any Pallas
kernel).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .database import Database
from .network import init_network, load_policy, save_policy


@dataclass
class TrainConfig:
    input_size: int = 47
    output_size: int = 12
    num_hidden_layer: int = 3
    hidden_dim: int = 512
    batch_norm: bool = True
    dropout_rate: float = 0.0
    learning_rate: float = 2.0e-3
    batch_size: int = 1024
    n_epochs: int = 500
    ckpt_every: int = 10
    val_fraction: float = 0.1
    ood_weight: float = 5.0
    seed: int = 0
    save_dir: str = "./policies"
    run_name: str = "bc"


class BehavioralCloning:
    """Supervised trainer over a Database. ``metrics`` holds one record an
    epoch (train_loss, the mean of its steps' losses; val_loss, in eval
    mode on the validation split; ood_val_loss with a validation database;
    wall, seconds since the first epoch began; on the card, step_ms, the
    epoch's steps between CUDA events over their number), ``step_losses``
    each epoch's per-step losses."""

    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = []
        self.step_losses = []

    def draw_batches(self, rng: np.random.Generator, train_idx: np.ndarray,
                     p_train: np.ndarray, n_batches: int) -> np.ndarray:
        """One epoch's (n_batches, batch_size) row indices: the JAX trainer's
        single draw."""
        return rng.choice(train_idx, size=(n_batches, self.cfg.batch_size), p=p_train)

    def run(self, database: Database, ood_mask: Optional[np.ndarray] = None,
            val_database: Optional[Database] = None, warm_start_path: Optional[str] = None,
            sample_weights: Optional[np.ndarray] = None) -> str:
        """Train; returns the path of the final policy payload.
        ``sample_weights`` (one per row) overrides the OOD x ``ood_weight``
        rule."""
        cfg, dev = self.cfg, self.device
        X, Y = database.training_arrays()
        n = len(X)
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(n)
        n_val = max(int(n * cfg.val_fraction), 1)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        if sample_weights is not None:
            w_train = np.asarray(sample_weights, np.float64)[train_idx]
        else:
            w_train = make_sample_weights(n, ood_mask, cfg.ood_weight)[train_idx]
        p_train = w_train / w_train.sum()

        if warm_start_path is not None:
            # the payload's architecture, not this config's: the checkpoints
            # must reload with the warm-started net's shapes
            net, _ = load_policy(warm_start_path, device=dev)
        else:
            net = init_network(cfg.input_size, cfg.output_size, cfg.num_hidden_layer,
                               cfg.hidden_dim, cfg.batch_norm, cfg.dropout_rate,
                               generator=torch.Generator().manual_seed(cfg.seed), device=dev)
        net_config = dict(net.net_config)
        net.dropout_generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)

        Xd, Yd = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
        val_d = torch.as_tensor(val_idx, device=dev)
        Xval, Yval = Xd[val_d], Yd[val_d]
        Xood = Yood = None
        if val_database is not None and len(val_database):
            xo, yo = val_database.training_arrays()
            Xood, Yood = torch.as_tensor(xo, device=dev), torch.as_tensor(yo, device=dev)

        n_batches = max(len(train_idx) // cfg.batch_size, 1)
        norm = database.get_database_mean_std()
        os.makedirs(cfg.save_dir, exist_ok=True)
        final_path = os.path.join(cfg.save_dir, f"policy_{cfg.run_name}_final.pkl")
        timed = dev.type == "cuda"
        t0 = time.time()
        for epoch in range(cfg.n_epochs):
            idx = torch.as_tensor(self.draw_batches(rng, train_idx, p_train, n_batches),
                                  device=dev)
            xb, yb = Xd[idx], Yd[idx]
            losses = torch.empty(n_batches, device=dev)
            net.train()
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            for i in range(n_batches):
                losses[i] = train_step(net, opt, xb[i], yb[i])
            if timed:
                ev[1].record()
            step_losses = losses.cpu().numpy()          # the epoch's one read
            rec = dict(epoch=epoch, train_loss=float(step_losses.mean(dtype=np.float32)),
                       val_loss=eval_loss(net, Xval, Yval))
            if timed:
                rec["step_ms"] = ev[0].elapsed_time(ev[1]) / n_batches
            rec["wall"] = time.time() - t0
            if Xood is not None:
                rec["ood_val_loss"] = eval_loss(net, Xood, Yood)
            self.metrics.append(rec)
            self.step_losses.append(step_losses)
            if (epoch + 1) % cfg.ckpt_every == 0 or epoch == cfg.n_epochs - 1:
                save_policy(os.path.join(cfg.save_dir, f"policy_{cfg.run_name}_ep{epoch + 1}.pkl"),
                            net, norm, net_config)
        save_policy(final_path, net, norm, net_config)
        with open(os.path.join(cfg.save_dir, f"metrics_{cfg.run_name}.jsonl"), "w") as f:
            for rec in self.metrics:
                f.write(json.dumps(rec) + "\n")
        return final_path


def train_step(net, opt, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One optimizer step on the L1 loss mean(|net(x) - y|); returns the
    loss, on the device (no host sync)."""
    opt.zero_grad(set_to_none=True)
    loss = torch.mean(torch.abs(net(x) - y))
    loss.backward()
    opt.step()
    return loss.detach()


def eval_loss(net, x: torch.Tensor, y: torch.Tensor) -> float:
    """The L1 loss of ``net`` in eval mode on (x, y); leaves ``net`` in
    eval mode."""
    net.eval()
    with torch.no_grad():
        return float(torch.mean(torch.abs(net(x) - y)))


def noisy_leaves(variables) -> set:
    """The (collection, layer, leaf) keys of Flax-layout ``variables``
    whose gradient is rounding noise: the Dense biases feeding a BatchNorm
    (its batch mean removes them) and the running means that follow them.
    Two fp32 trainers on the same batches part there first: Adam scales the
    noise to steps of up to ~lr."""
    bns = list(variables.get("batch_stats", {}))
    return ({("params", "Dense_" + k.split("_")[1], "bias") for k in bns}
            | {("batch_stats", k, "mean") for k in bns})


def trained_gaps(va, vb, const_inputs=()) -> Tuple[float, float]:
    """Two Flax-layout variable dicts after the same training: (the largest
    |a - b| over the leaves training drives, the largest over the noisy
    ones). Noisy: ``noisy_leaves`` and the first layer's rows of the input
    columns ``const_inputs`` (constant over the data: a second bias).
    Raises ValueError when the two hold different leaves."""
    keys = [{(c, layer, leaf) for c in v for layer in v[c] for leaf in v[c][layer]}
            for v in (va, vb)]
    if keys[0] != keys[1]:
        raise ValueError(f"different leaves: {sorted(keys[0] ^ keys[1])}")
    noisy = noisy_leaves(va)
    worst = worst_noisy = 0.0
    for col in va:
        for layer in va[col]:
            for leaf, a in va[col][layer].items():
                d = np.abs(np.asarray(a, np.float64)
                           - np.asarray(vb[col][layer][leaf], np.float64))
                mask = np.full(d.shape, (col, layer, leaf) in noisy)
                if (col, layer, leaf) == ("params", "Dense_0", "kernel"):
                    mask[list(const_inputs)] = True
                worst = max(worst, float(d[~mask].max(initial=0.0)))
                worst_noisy = max(worst_noisy, float(d[mask].max(initial=0.0)))
    return worst, worst_noisy


def make_sample_weights(n: int, ood_mask: Optional[np.ndarray],
                        ood_weight: float) -> np.ndarray:
    """Per-row sampling weights: 1 in distribution, ``ood_weight`` for the
    rows ``ood_mask`` flags."""
    weights = np.ones(n)
    if ood_mask is not None:
        weights[np.asarray(ood_mask, bool)] = ood_weight
    return weights


def compute_ood_mask(states: np.ndarray, nominal_states: np.ndarray,
                     traj_times: np.ndarray, nominal_times: np.ndarray,
                     threshold: float = 4.0) -> np.ndarray:
    """Out of distribution: the L2 distance to the time-aligned nominal
    state above ``threshold``."""
    order = np.argsort(nominal_times)
    nom_t = nominal_times[order]
    nom_s = nominal_states[order]
    idx = np.clip(np.searchsorted(nom_t, traj_times), 0, len(nom_t) - 1)
    d = np.linalg.norm(states - nom_s[idx], axis=-1)
    return d > threshold
