"""Kernel 4 (terminal Gram and sweep to the gains, N > 88)."""
from port_bench.harness.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("riccati_sweep_terminal_kernel",), "riccati_sweep_terminal")
