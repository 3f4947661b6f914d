"""Kernel 5 (the alpha = 1 rollout over the gains, N > 88)."""
from port_bench.harness.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("forward_rollout_kernel",), "forward_rollout")
