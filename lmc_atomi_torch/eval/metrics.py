"""Imaging quality metrics (counterpart of ``lmc_atomi_tpu/eval/metrics.py``).

``snr`` follows the reference's definition (prox_lmc_deconv.py:35-36);
``psnr``/``mse`` follow skimage: ``data_range`` defaults to the max minus the
min of the true image.
"""
from __future__ import annotations

import torch

__all__ = ["snr", "psnr", "mse"]


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
