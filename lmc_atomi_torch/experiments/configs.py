"""Shared experiment problem definitions (a copy of
``lmc_atomi_tpu/experiments/configs.py``: the port imports nothing of the
JAX package).

The numeric mixture configurations (means/covariances for n in 1..5) are the
reference's benchmark *problem data* (lmc.py:204-235, prox_lmc.py:273-300,
lmc_laplace.py:229-247 analogues), reproduced so results are comparable.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gaussian_mixture_config", "laplace_mixture_config", "GRID_POSITIONS"]

_MU = [
    np.array([0.0, 0.0]),
    np.array([-2.0, 3.0]),
    np.array([2.0, -3.0]),
    np.array([3.0, 3.0]),
    np.array([-2.0, -2.0]),
]
_SIGMA = [
    np.array([[1.0, -0.5], [-0.5, 1.0]]),
    np.array([[0.5, 0.2], [0.2, 0.7]]),
    np.array([[0.5, 0.1], [0.1, 0.9]]),
    np.array([[0.8, 0.02], [0.02, 0.3]]),
    np.array([[1.2, 0.05], [0.05, 0.8]]),
]


def gaussian_mixture_config(n: int):
    """Means/covs/weights for the n-component benchmark mixture. n=4 uses
    components 2-5 (reference lmc.py:227-228)."""
    if n == 4:
        mus, sigmas = _MU[1:5], _SIGMA[1:5]
    else:
        mus, sigmas = _MU[:n], _SIGMA[:n]
    return (
        np.stack(mus),
        np.stack(sigmas),
        np.ones(n) / n,
    )


def laplace_mixture_config(n: int, alpha: float = 1.0):
    """Location/scale config for the Laplacian-mixture workload: the same
    five locations with per-component inverse scales alpha_i = alpha."""
    if n == 4:
        mus = _MU[1:5]
    else:
        mus = _MU[:n]
    return np.stack(mus), alpha * np.ones(n), np.ones(n) / n


GRID_POSITIONS = [-4.0, -2.0, 0.0, 2.0, 4.0]  # 25-mode grid (jax/sgld.py)
