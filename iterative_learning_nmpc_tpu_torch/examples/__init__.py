"""Command-line entry points of the port, the counterparts of the JAX
package's ``examples/`` CLIs (run with ``python -m
iterative_learning_nmpc_tpu_torch.examples.<name>``)."""
