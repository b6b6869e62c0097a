"""A frozen copy of the port's plain PyTorch path: the benchmark's
reference.

These modules are copies of ``apnerf_torch``'s models, ops, kinematics,
the kernels' plain versions, the masked Adam and the ray helpers, taken
when the benchmark was defined, with one change: ``kernels.on_cpu`` is
always true, so every kernel wrapper runs its plain version, on the card
too. They import nothing of the program, and later changes to the
program do not reach them: the benchmark holds the program to this
copy. Do not edit them to follow the program.
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
            "the reference runs on a CUDA device and none is available; pass "
            "device=\"cpu\" to run on the CPU (the kernels' plain versions)")
    return torch.device("cuda")
