"""Helpers of the per-layer metric readers in ``port_bench/metrics/``.

A reader gets ``ctx``: the cell's shapes (``B``, ``N``, ``n_alpha``,
``fused``), the inner passes a step (``passes_per_step``, the kernel-2
launch counter over the window), the mean step time of the untraced steps
(``mean_step_s``) and the traced stretch (``trace``: ``busy_s``,
``window_s``, ``steps``, ``kernels`` {name: (seconds, calls)}).
"""
from __future__ import annotations

from .. import roofline


def kernel_share(ctx: dict, names: tuple, kernel: str):
    """Roofline share (%) of one wrapper's launch: its least time over the
    device time of its kernels (``names``, the first counting the calls)
    a call; None when the trace holds no call."""
    ks = ctx["trace"]["kernels"]
    if names[0] not in ks or ks[names[0]][1] == 0:
        return None
    t = sum(ks[n][0] for n in names if n in ks) / ks[names[0]][1]
    f, b = roofline.kernels(ctx["B"], ctx["N"], ctx["n_alpha"], ctx["fused"])[kernel]
    return 100.0 * roofline.least_s(f, b) / t
