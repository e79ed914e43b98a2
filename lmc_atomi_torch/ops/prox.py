"""Proximal operators (counterpart of ``lmc_atomi_tpu/ops/prox.py``). The
deconvolution slice needs only the soft threshold; the mixture proxes come
with the mixtures slice."""
from __future__ import annotations

import torch

__all__ = ["prox_laplace"]


def prox_laplace(x, gamma):
    """Soft-thresholding: prox of ``gamma * |.|_1`` (reference prox.py:18-19)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - gamma, min=0.0)
