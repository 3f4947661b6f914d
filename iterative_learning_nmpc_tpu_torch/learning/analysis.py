"""Offline dataset / policy diagnostics.

The port's copy of ``iterative_learning_nmpc_tpu/learning/analysis.py``:
library-form equivalents of the reference's analysis scripts
(`Behavior_Cloning/examples/plot_*.py`, `DAgger/test/plot_*.py`,
`smooth_mpc_data.py`, `test_maxmin_action.py`):

- PCA of state distributions (plot_PCA_analysis.py) — one dataset or several
  overlaid,
- per-dimension dataset distribution histograms
  (plot_one_dataset_distribution.py, plot_multiple_dataset_distribution_dimensionwise.py),
- velocity-goal tracking error (plot_vc_goal_error.py, plot_policy_tracking.py),
- perturbed-vs-nominal state distance (plot_perturbed_vs_nominal_distance.py),
- feet positions over time (plot_feet_position.py),
- Butterworth low-pass smoothing of recorded trajectories (smooth_mpc_data.py,
  5 Hz default; scipy, imported where it is used),
- action bounds report (test_maxmin_action.py).

All functions return arrays/figures (numpy); matplotlib is imported only by
the figure builders, so the numeric paths import without it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# numeric cores
# ---------------------------------------------------------------------------

def pca(states: np.ndarray, n_components: int = 2):
    """Plain SVD PCA. Returns (projected, components, explained_ratio)."""
    X = np.asarray(states, dtype=np.float64)
    mu = X.mean(axis=0)
    Xc = X - mu
    U, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    proj = Xc @ Vt[:n_components].T
    var = S**2 / max(len(X) - 1, 1)
    ratio = var[:n_components] / var.sum()
    return proj, Vt[:n_components], ratio


def velocity_goal_error(v_realized: np.ndarray, v_goal: np.ndarray):
    """Per-step and mean |v_xy - goal_xy| (the SafeDAgger tracking metric)."""
    err = np.abs(np.asarray(v_realized)[:, :2] - np.asarray(v_goal)[:, :2])
    return err, err.mean(axis=0)


def perturbed_vs_nominal_distance(
    states: np.ndarray, times: np.ndarray,
    nominal_states: np.ndarray, nominal_times: np.ndarray,
):
    """L2 distance of each state to the time-aligned nominal state."""
    order = np.argsort(nominal_times)
    nt, ns = np.asarray(nominal_times)[order], np.asarray(nominal_states)[order]
    idx = np.clip(np.searchsorted(nt, times), 0, len(nt) - 1)
    return np.linalg.norm(np.asarray(states) - ns[idx], axis=-1)


def butterworth_lowpass(signal: np.ndarray, cutoff_hz: float = 5.0,
                        fs_hz: float = 1000.0, order: int = 4) -> np.ndarray:
    """Zero-phase Butterworth low-pass (reference smooth_mpc_data.py)."""
    from scipy.signal import butter, filtfilt

    b, a = butter(order, cutoff_hz / (0.5 * fs_hz), btype="low")
    return filtfilt(b, a, np.asarray(signal), axis=0)


def action_bounds(actions: np.ndarray):
    """min/max per action dim (reference test_maxmin_action.py)."""
    a = np.asarray(actions)
    return a.min(axis=0), a.max(axis=0)


def expert_influence_ratio(is_expert: np.ndarray) -> float:
    m = np.asarray(is_expert, dtype=np.float64)
    return float(m.mean()) if m.size else 0.0


# ---------------------------------------------------------------------------
# figure builders (lazy matplotlib)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_pca_analysis(datasets, labels=None, save_path: Optional[str] = None):
    """Scatter of the first two PCs of one or more state datasets."""
    plt = _plt()
    labels = labels or [f"dataset {i}" for i in range(len(datasets))]
    all_states = np.concatenate([np.asarray(d) for d in datasets], axis=0)
    _, components, ratio = pca(all_states, 2)
    mu = all_states.mean(axis=0)
    fig, ax = plt.subplots(figsize=(7, 6))
    for d, lab in zip(datasets, labels):
        proj = (np.asarray(d) - mu) @ components.T
        ax.scatter(proj[:, 0], proj[:, 1], s=3, alpha=0.4, label=lab)
    ax.set_xlabel(f"PC1 ({ratio[0]:.1%})")
    ax.set_ylabel(f"PC2 ({ratio[1]:.1%})")
    ax.legend()
    ax.set_title("State-distribution PCA")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_dataset_distribution(states, dims=None, bins=60,
                              labels=None, save_path: Optional[str] = None):
    """Per-dimension histograms; accepts one array or a list to overlay."""
    plt = _plt()
    if isinstance(states, np.ndarray):
        states = [states]
    labels = labels or [f"dataset {i}" for i in range(len(states))]
    dims = dims if dims is not None else range(states[0].shape[1])
    dims = list(dims)
    ncols = 4
    nrows = (len(dims) + ncols - 1) // ncols
    fig, axs = plt.subplots(nrows, ncols, figsize=(4 * ncols, 2.5 * nrows))
    axs = np.atleast_1d(axs).ravel()
    for k, d in enumerate(dims):
        for s, lab in zip(states, labels):
            axs[k].hist(np.asarray(s)[:, d], bins=bins, alpha=0.5,
                        density=True, label=lab)
        axs[k].set_title(f"dim {d}")
    axs[0].legend()
    for k in range(len(dims), len(axs)):
        fig.delaxes(axs[k])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_policy_tracking(times, v_realized, v_goal, save_path=None):
    plt = _plt()
    err, mean_err = velocity_goal_error(v_realized, v_goal)
    fig, axs = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    axs[0].plot(times, np.asarray(v_realized)[:, 0], label="vx")
    axs[0].plot(times, np.asarray(v_goal)[:, 0], "--", label="vx goal")
    axs[0].plot(times, np.asarray(v_realized)[:, 1], label="vy")
    axs[0].plot(times, np.asarray(v_goal)[:, 1], "--", label="vy goal")
    axs[0].legend()
    axs[0].set_ylabel("m/s")
    axs[1].plot(times, err[:, 0], label="|vx err|")
    axs[1].plot(times, err[:, 1], label="|vy err|")
    axs[1].axhline(0.10, color="r", ls=":", label="safety tol")
    axs[1].legend()
    axs[1].set_xlabel("t [s]")
    fig.suptitle(f"velocity tracking, mean err {mean_err.round(3)}")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_feet_position(times, feet_pos_w, save_path=None):
    """feet_pos_w: (T, 12) flattened (FL,FR,RL,RR) x (x,y,z)."""
    plt = _plt()
    f = np.asarray(feet_pos_w).reshape(len(times), 4, 3)
    fig, axs = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
    for i, leg in enumerate(("FL", "FR", "RL", "RR")):
        for d, name in enumerate("xyz"):
            axs[d].plot(times, f[:, i, d], label=leg)
            axs[d].set_ylabel(f"foot {name} [m]")
    axs[0].legend(ncol=4)
    axs[2].set_xlabel("t [s]")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_perturbed_vs_nominal(times, states, nominal_times, nominal_states,
                              threshold: float = 4.0, save_path=None):
    """Distance-to-nominal over time with the OOD threshold line
    (reference plot_perturbed_vs_nominal_distance.py + the L2>threshold OOD
    rule of the pretrain collection)."""
    plt = _plt()
    d = perturbed_vs_nominal_distance(states, times, nominal_states,
                                      nominal_times)
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(times, d, label="|state - nominal|")
    ax.axhline(threshold, color="r", ls=":",
               label=f"OOD threshold ({threshold})")
    frac = float((d > threshold).mean())
    ax.set_xlabel("t [s]")
    ax.set_ylabel("L2 distance")
    ax.set_title(f"perturbed vs nominal ({frac:.1%} OOD)")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_smoothing_comparison(times, signal, cutoff_hz: float = 5.0,
                              fs_hz: float = 1000.0, dims=None,
                              save_path=None):
    """Raw vs Butterworth-filtered trajectory overlay (reference
    smooth_mpc_one_traj.py)."""
    plt = _plt()
    sig = np.atleast_2d(np.asarray(signal))
    if sig.shape[0] == 1:
        sig = sig.T
    smooth = butterworth_lowpass(sig, cutoff_hz, fs_hz)
    dims = list(dims) if dims is not None else list(range(sig.shape[1]))
    ncols = min(3, len(dims))
    nrows = (len(dims) + ncols - 1) // ncols
    fig, axs = plt.subplots(nrows, ncols, figsize=(5 * ncols, 2.6 * nrows),
                            squeeze=False)
    axs = axs.ravel()
    for k, d in enumerate(dims):
        axs[k].plot(times, sig[:, d], alpha=0.4, label="raw")
        axs[k].plot(times, smooth[:, d], label=f"{cutoff_hz:g} Hz")
        axs[k].set_title(f"dim {d}")
    axs[0].legend()
    for k in range(len(dims), len(axs)):
        fig.delaxes(axs[k])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_action_bounds(actions, joint_limits=None, save_path=None):
    """Per-dimension action min/max span, optionally against the joint
    limits (reference test_maxmin_action.py as a figure)."""
    plt = _plt()
    lo, hi = action_bounds(actions)
    dims = np.arange(len(lo))
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.vlines(dims, lo, hi, lw=6, alpha=0.7, label="action span")
    if joint_limits is not None:
        jl = np.asarray(joint_limits)
        ax.plot(dims, jl[:, 0], "rv", label="joint lower")
        ax.plot(dims, jl[:, 1], "r^", label="joint upper")
    ax.set_xlabel("action dim")
    ax.set_ylabel("rad")
    ax.set_title("PD-target action bounds")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_expert_segments(times, is_expert, save_path=None):
    """Expert/learner mode timeline with the expert-influence ratio
    (the SafeDAgger observability figure; ratio metric from
    `data_collection_locosafedagger.py:219-223`)."""
    plt = _plt()
    m = np.asarray(is_expert, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(9, 2.4))
    ax.fill_between(times, 0, m, step="post", alpha=0.6, label="expert (MPC)")
    ax.set_yticks([0, 1])
    ax.set_yticklabels(["policy", "expert"])
    ax.set_xlabel("t [s]")
    ax.set_title(f"control mode (expert influence {expert_influence_ratio(m):.1%})")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
