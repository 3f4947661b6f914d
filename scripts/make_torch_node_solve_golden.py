"""Write the golden of the sublane node solve, which the PyTorch port's node
solve (``ops/probes.py``: ``node_solve_plain`` on the CPU, the
``node_solve_warp`` kernel on the card) is held to.

Runs ``_solve_node_sublane`` of ``scripts/proto_sublane_riccati.py`` (the
body of the TPU kernel ``_kernel_sublane``: Cholesky pivot by pivot on the
shrinking submatrix, the forward solve row by row, the value update as a sum
of 30 outer products) once under ``jax.jit`` on the CPU, on 37 nodes of the
prototype's random blocks (``reference_node_blocks(37, 1, seed=5)``: Quu =
G G^T + 3 I) laid out as (d1, d2, nodes). 37 is odd, fewer than the
persistent kernel's resident warps and no multiple of a block's warps, so
the kernel's ragged edge is covered. Stores the batch-major inputs
(``Qxx, Quu, Qux, qxp, qu``) and outputs (``K, kff, P, p``) in
``tests/data/node_solve_sublane_golden.npz``. The solve takes ~25 s to
compile and run here, too long for the tier-1 tests, which read this file.

    python scripts/make_torch_node_solve_golden.py
"""
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "node_solve_sublane_golden.npz")
NODES, SEED = 37, 5


def main():
    from iterative_learning_nmpc_tpu_torch.ops.probes import reference_node_blocks

    spec = importlib.util.spec_from_file_location(
        "proto_sublane_riccati", os.path.join(ROOT, "scripts", "proto_sublane_riccati.py"))
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)

    names = ("Qxx", "Quu", "Qux", "qxp", "qu")
    blocks = {k: t.numpy()[:, 0] for k, t in zip(names, reference_node_blocks(NODES, 1, SEED))}
    # (nodes, d1[, d2]) -> (d1, d2, nodes), the vectors as (d, 1, nodes)
    laid = {k: jnp.asarray(np.moveaxis(x if x.ndim == 3 else x[..., None], 0, -1))
            for k, x in blocks.items()}
    K, kff, P, p = jax.jit(proto._solve_node_sublane)(*(laid[k] for k in names))
    out = dict(blocks)
    for k, x in (("K", K), ("kff", kff), ("P", P), ("p", p)):
        x = np.moveaxis(np.asarray(x), -1, 0)
        out[k] = x[..., 0] if x.shape[-1] == 1 else x
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB): "
          + ", ".join(f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
