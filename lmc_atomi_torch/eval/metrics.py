"""Imaging quality metrics (counterpart of ``lmc_atomi_tpu/eval/metrics.py``).

``snr`` follows the reference's definition (prox_lmc_deconv.py:35-36);
``psnr``/``mse`` follow skimage: ``data_range`` defaults to the max minus the
min of the true image. ``acceptance_rate`` and ``effective_sample_mask`` read
the list of ``StepInfo`` that ``run_chain`` returns.
"""
from __future__ import annotations

import torch

__all__ = ["snr", "psnr", "mse", "acceptance_rate", "effective_sample_mask"]


def snr(image_true, image_test):
    """20 log10(||x|| / ||x_hat - x||)."""
    num = torch.linalg.norm(torch.ravel(image_true))
    den = torch.linalg.norm(torch.ravel(image_test - image_true))
    return 20.0 * torch.log10(num / den)


def mse(image_true, image_test):
    return torch.mean(torch.square(image_true - image_test))


def psnr(image_true, image_test, data_range=None):
    """Peak SNR; ``data_range`` defaults to max-min of the true image."""
    if data_range is None:
        data_range = torch.max(image_true) - torch.min(image_true)
    return 10.0 * torch.log10((data_range ** 2) / mse(image_true, image_test))


def effective_sample_mask(infos):
    """Boolean tensor of the accepted steps: filtering the stacked samples
    with it gives the reference MALA's sample set, which drops rejected
    proposals (lmc.py:128-131)."""
    return torch.stack([torch.as_tensor(info.accepted) for info in infos])


def acceptance_rate(infos):
    """Fraction of accepted Metropolis-Hastings steps (0-d float32 tensor)."""
    return torch.mean(effective_sample_mask(infos).to(torch.float32))
