"""Kernel 3 (terminal Gram, sweep and alpha = 1 rollout, fused)."""
from port_bench.harness.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("riccati_rollout_kernel",), "riccati_rollout")
