"""The result line of a run and the check's lines on standard error."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import torch

from . import cell as cells


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def end_to_end(res: dict) -> dict:
    """Every end-to-end metric the harness knows, by name."""
    return dict(solves_per_s=res["attempted"] / res["window_s"],
                rti_step_ms_p95=float(np.percentile(res["step_ms"], 95)),
                setup_s=res["setup_s"])


def reader_ctx(res: dict) -> dict:
    c = res["cell"]
    traced = set(res["trace"]["traced_steps"]) if res["trace"] else set()
    untraced = [t for i, t in enumerate(res["step_ms"]) if i not in traced]
    n = max(res["steps"], 1)
    return dict(B=res["batch"], N=c.traffic["n_nodes"],
                n_alpha=len(c.config["ls_alphas_steady"]),
                fused=res["launches"]["riccati_rollout"] > 0,
                passes_per_step=res["launches"]["lingram"] / n,
                mean_step_s=float(np.mean(untraced)) * 1e-3 if untraced else None,
                trace=res["trace"])


def assemble(res: dict, trace: bool):
    cell = res["cell"]
    if trace:
        ctx = reader_ctx(res)
        metrics = {}
        for m in cell.per_layer:
            v = cells.load_reader(m["name"], cell.bench_dir)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        known = end_to_end(res)
        metrics = {m["name"]: {"value": float(known[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    limits = cell.traffic["limits"]
    nums = res["numbers"]
    checked = {k: {"value": float(nums[k]), "limit": float(lim)} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checked.values()) and res["failed"] == 0
    on_gpu = res["device"].type == "cuda"
    device = {"platform": "gpu" if on_gpu else "cpu",
              "kind": torch.cuda.get_device_name(res["device"]) if on_gpu else "cpu",
              "count": 1, "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit_w": _power_limit_w() if on_gpu else None}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device}
    if trace and res["trace"]:
        tr = res["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k, v[0]] for k, v in ops],
                             "idle_gaps": [[k, v] for k, v in gaps]}
    line["check"] = checked
    lines = [f"steps {res['steps']} window_s {res['window_s']} passes_per_step "
             f"{res['launches']['lingram'] / max(res['steps'], 1)} solves_compared "
             f"{nums['solves_compared']} passes_off {nums['passes_off']} pass_need "
             f"{nums['pass_need']} alpha_need {nums['alpha_need']} check_s {nums['check_s']}"]
    lines += [f"check {k}: {c['value']} <= {c['limit']}" for k, c in checked.items()]
    lines.append(f"correct {correct} failed {res['failed']}")
    return line, lines


JAX_NAMES = ("jax", "jaxlib", "flax", "iterative_learning_nmpc_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def emit(res: dict, trace: bool, out=None) -> int:
    """Assemble the run's result, write the check's lines to standard error
    and the result line to ``out`` (standard output); the exit code. No line
    is written when a JAX module is loaded at that point (everything the run
    loaded once the window closed, the check and the readers with it) or a
    metric is not finite."""
    line, lines = assemble(res, trace)
    for text in lines:
        print(text, file=sys.stderr)
    found = jax_modules()
    if found:
        print("loaded once the window closed: " + ", ".join(found), file=sys.stderr)
        return 3
    if any(not math.isfinite(m["value"]) for m in line["metrics"].values()):
        print("a metric is not finite", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(line), file=out or sys.stdout)
    return 0
