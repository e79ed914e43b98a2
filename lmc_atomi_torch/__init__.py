"""PyTorch/CUDA port of ``lmc_atomi_tpu`` for the NVIDIA H100.

The subpackages mirror the JAX package (``core``, ``ops``, ``models``,
``kernels``, ``run``, ``eval``, ``parallel``, ``utils``, ``experiments``) with the
same module and function names. Plain tensor code is PyTorch; the TPU kernels ported so far
(the TV prox, the fused MYULA and ULPDA blocks, and the fused wavelet
MYULA and wavelet-dual ULPDA blocks) are
hand-written CUDA in ``csrc/``, built at first use by ``_build.py``.
The package imports torch, numpy and scipy, never JAX. Importing it builds no
CUDA kernel and imports no matplotlib.
"""

from lmc_atomi_torch import core, eval, kernels, models, ops, parallel, run, utils  # noqa: F401,E402
