"""PyTorch / CUDA port of the apnerf stage-2 point-model render.

The JAX package ``apnerf`` stays the reference; this package mirrors its
layout (``ops``, ``kernels``, ``models``, ``utils``, ``render``) and holds
the hand-written Hopper kernels under ``csrc``. It imports no jax.
"""
