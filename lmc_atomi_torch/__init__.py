"""PyTorch/CUDA port of ``lmc_atomi_tpu`` for the NVIDIA H100.

The subpackages mirror the JAX package (``core``, ``ops``, ``kernels``,
``run``, ``eval``, ``utils``) with the same module and function names. Plain
tensor code is PyTorch; the two TPU kernels of the MYULA TV-deblur main path
are hand-written CUDA in ``csrc/`` (built at first use by ``_build.py``).
The package imports torch, numpy and scipy, never JAX.
"""
