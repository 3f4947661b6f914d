"""The whole step's roofline share: the least time of its passes (each
linearize, Riccati sweep and rollout, merit at the cell's shapes) over the
mean time of the window's untraced steps."""
from port_bench import roofline


def read(ctx):
    if not ctx["mean_step_s"] or not ctx["passes_per_step"]:
        return None
    least = ctx["passes_per_step"] * roofline.pass_least_s(
        ctx["B"], ctx["N"], ctx["n_alpha"], ctx["fused"])
    return 100.0 * least / ctx["mean_step_s"]
