"""iterative_learning_nmpc_tpu_torch — the PyTorch + CUDA port of the
quadruped NMPC stack (so far: the batched warm-started RTI solve and the
closed-loop controller on a device plant).

Sub-packages mirror ``iterative_learning_nmpc_tpu``:

- ``robots``  : ``RobotSpec`` as a dataclass of tensors, the Go2 model.
- ``models``  : batched rigid-body dynamics (FK, foot velocities, RNEA, mass
                matrix, forward dynamics) and numpy state conversions.
- ``ocp``     : the Gauss-Newton residual stack of the whole-body OCP.
- ``mpc``     : configuration, plan interpolation and ``LocomotionMPC``.
- ``gait``    : cyclic contact planners (numpy host API).
- ``solver``  : the batched GN-SQP/RTI solver with per-problem early exits,
                and the phase-aligned cold boot.
- ``sim``     : the soft-contact plant on the device.
- ``ops``     : hand-written CUDA kernels (``csrc/``) with plain PyTorch
                twins; CPU tensors take the twin, CUDA tensors the kernel.

Entry points run on the CUDA card unless the caller names a device
(``device.resolve_device``). The package imports neither ``jax`` nor the
JAX package.
"""

__version__ = "0.1.0"

import torch as _torch

# The Riccati recursions on 36x36 blocks and the RNEA chains need true fp32
# accumulation (the counterpart of jax_default_matmul_precision="highest"
# in the JAX package): TF32 would silently keep ~10 mantissa bits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
