"""Offline dataset/policy analysis CLI, the counterpart of the JAX package's
``examples/analyze_dataset.py`` with the same arguments: the runnable
counterpart of the reference's plot scripts (`Behavior_Cloning/examples/plot_*.py`,
`DAgger/test/plot_*.py`, `smooth_mpc_data.py`, `test_maxmin_action.py`),
driving `learning/analysis.py` figure builders over one or more HDF5/npz
datasets.

    python -m iterative_learning_nmpc_tpu_torch.examples.analyze_dataset \
        --dataset ./data/database_0.npz --out ./figs   # all applicable figures
    python -m iterative_learning_nmpc_tpu_torch.examples.analyze_dataset \
        --dataset a.hdf5 b.hdf5 --figures pca dist     # PCA + distributions overlaid
    python -m iterative_learning_nmpc_tpu_torch.examples.analyze_dataset \
        --dataset run.npz --nominal nom.npz --figures ood   # distance to nominal
"""
import argparse
import os
import sys

import numpy as np

FIGURES = ("pca", "dist", "tracking", "feet", "ood", "smooth", "actions",
           "expert")


def _load(path):
    """(states, actions, vc_goals, traj_times, extras dict) from hdf5/npz."""
    if path.endswith((".hdf5", ".h5")):
        from ..learning.database import Database

        db = Database(limit=10**7)
        db.load_saved_database(path)
        return (db.states_array(), db.actions_array(), db.goals_array(),
                db.traj_times[db._order()], {})
    raw = dict(np.load(path, allow_pickle=True))
    extras = {k: raw[k] for k in ("feet_pos_w", "v", "is_expert", "time")
              if k in raw}
    states = raw.get("state", raw.get("states"))
    return (states, raw.get("action", raw.get("actions")),
            raw.get("vc_goal", raw.get("vc_goals")),
            raw.get("time"), extras)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", nargs="+", required=True,
                    help="one or more .hdf5 / .npz dataset files")
    ap.add_argument("--nominal", default=None,
                    help="nominal rollout npz for the OOD-distance figure")
    ap.add_argument("--figures", nargs="+", default=["all"],
                    choices=list(FIGURES) + ["all"])
    ap.add_argument("--out", default="./analysis_figs")
    ap.add_argument("--ood_threshold", type=float, default=4.0)
    ap.add_argument("--cutoff_hz", type=float, default=5.0)
    args = ap.parse_args(argv)

    from ..learning import analysis as an
    from .run_mpc import print_launches

    want = set(FIGURES) if "all" in args.figures else set(args.figures)
    os.makedirs(args.out, exist_ok=True)
    loaded = [_load(p) for p in args.dataset]
    labels = [os.path.basename(p) for p in args.dataset]
    states = [l[0] for l in loaded]
    t0 = loaded[0][3]
    times = (np.asarray(t0) if t0 is not None
             else np.arange(len(states[0])) * 1e-3)
    made = []

    def save(name, fig_or_none):
        if fig_or_none is not None:
            made.append(os.path.join(args.out, name))

    if "pca" in want:
        save("pca.png", an.plot_pca_analysis(
            states, labels, save_path=os.path.join(args.out, "pca.png")))
    if "dist" in want:
        save("distributions.png", an.plot_dataset_distribution(
            states, labels=labels,
            save_path=os.path.join(args.out, "distributions.png")))
    if "actions" in want:
        save("action_bounds.png", an.plot_action_bounds(
            loaded[0][1],
            save_path=os.path.join(args.out, "action_bounds.png")))
        lo, hi = an.action_bounds(loaded[0][1])
        print("action min:", np.round(lo, 3))
        print("action max:", np.round(hi, 3))
    if "tracking" in want and loaded[0][2] is not None:
        # state columns 1:3 are base vx, vy (44-dim contract)
        v_real = np.asarray(states[0])[:, 1:3]
        goals = np.asarray(loaded[0][2])[:, :2]
        save("tracking.png", an.plot_policy_tracking(
            times[:len(v_real)], v_real, goals,
            save_path=os.path.join(args.out, "tracking.png")))
    if "feet" in want and "feet_pos_w" in loaded[0][4]:
        f = loaded[0][4]["feet_pos_w"]
        save("feet.png", an.plot_feet_position(
            times[:len(f)], f.reshape(len(f), -1),
            save_path=os.path.join(args.out, "feet.png")))
    if "ood" in want and args.nominal:
        nom = _load(args.nominal)
        save("ood_distance.png", an.plot_perturbed_vs_nominal(
            times[:len(states[0])], states[0], nom[3], nom[0],
            threshold=args.ood_threshold,
            save_path=os.path.join(args.out, "ood_distance.png")))
    if "smooth" in want:
        save("smoothing.png", an.plot_smoothing_comparison(
            times[:len(states[0])], np.asarray(states[0])[:, 1:4],
            cutoff_hz=args.cutoff_hz,
            save_path=os.path.join(args.out, "smoothing.png")))
    if "expert" in want and "is_expert" in loaded[0][4]:
        m = loaded[0][4]["is_expert"]
        save("expert_segments.png", an.plot_expert_segments(
            times[:len(m)], m,
            save_path=os.path.join(args.out, "expert_segments.png")))

    print(f"wrote {len(made)} figure(s) to {args.out}:")
    for p in made:
        print(" ", p)
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
