"""Kernel 2 (linearize + Gram: rows, mass and Gram launches summed)."""
from port_bench.harness.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, ("lingram_rows_kernel", "lingram_mass_kernel",
                              "lingram_gram_kernel"), "lingram")
