"""PyTorch / CUDA port of apnerf: both training stages and the export, the
render with its evaluation and repose entry points, the command line, and
multi-device training and rendering.

The JAX package ``apnerf`` stays the reference; this package mirrors its
layout (``ops``, ``kernels``, ``models``, ``kinematics``, ``train``,
``render``, ``parallel``, ``utils``, ``cli``) and holds the hand-written
Hopper kernels under ``csrc``. It imports no jax.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA device
    and raises when there is none; the CPU is used only when asked for
    (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "apnerf_torch runs on a CUDA device and none is available; pass "
            "device=\"cpu\" to run on the CPU (the kernels' plain versions)")
    return torch.device("cuda")
