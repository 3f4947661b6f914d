"""The whole step's share of the float32 peak: the algorithm's operations
of its passes over the mean untraced step time x 67 TFLOP/s."""
from port_bench import roofline


def read(ctx):
    if not ctx["mean_step_s"] or not ctx["passes_per_step"]:
        return None
    flops = ctx["passes_per_step"] * roofline.pass_flops(
        ctx["B"], ctx["N"], ctx["n_alpha"], ctx["fused"])
    return 100.0 * flops / (ctx["mean_step_s"] * roofline.PEAK_FLOPS)
