"""Where the port's entry points put their tensors.

Every entry point (``flagship``, ``go2_spec``, ``build_quadruped_spec``,
``TrajOptSolver``, the ``interop`` converters, ``LocomotionMPC`` and the
device plant) runs on the CUDA card unless the caller names a device.
Without a card and without an explicit device they raise: the port never
falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device asked for, else the current CUDA card; raises when no
    device is named and CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run it on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
