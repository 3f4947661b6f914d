"""Dataset file utilities (reference ``DAgger/utils/dataset_utils.py`` +
``download_dataset.py``).

The port's numpy copy of ``iterative_learning_nmpc_tpu/learning/dataset_utils.py``.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

import numpy as np


def merge_npz(paths: Sequence[str], out_path: str,
              keys: Sequence[str] = ("state", "action", "vc_goals", "cc_goals", "time")) -> str:
    """Concatenate per-rollout npz files along the time axis
    (reference ``dataset_utils.py:4-20``)."""
    merged: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
    for p in paths:
        with np.load(p) as data:
            for k in keys:
                if k in data:
                    merged[k].append(np.asarray(data[k]))
    out = {k: np.concatenate(v, axis=0) for k, v in merged.items() if v}
    np.savez(out_path, **out)
    return out_path


def find_rollouts(record_dir: str, pattern: str = "traj_*.npz") -> List[str]:
    return sorted(glob.glob(os.path.join(record_dir, pattern)))


def download_dataset(repo_id: str = "Chiniklas/behavior_cloning_data",
                     local_dir: str = "./data/hf"):
    """Fetch the published BC dataset from HuggingFace
    (reference ``download_dataset.py:1-21``). Raises ``RuntimeError``
    unless ``huggingface_hub`` is importable; generate data locally with
    ``examples/collect_bc_data.py`` instead."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed. Generate data locally with "
            "python -m iterative_learning_nmpc_tpu_torch.examples.collect_bc_data "
            "instead.") from e
    return snapshot_download(repo_id=repo_id, repo_type="dataset",
                             local_dir=local_dir)
