"""Kernel 1 (FK + RNEA of every line-search candidate: the merit and duals)."""
from port_bench.harness.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("dyncore_kernel",), "dyncore")
