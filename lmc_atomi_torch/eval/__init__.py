"""Quality metrics, MCMC diagnostics and Wasserstein distances."""
from lmc_atomi_torch.eval.diagnostics import (
    autocorrelation,
    effective_sample_size,
    split_rhat,
)
from lmc_atomi_torch.eval.metrics import (
    acceptance_rate,
    effective_sample_mask,
    mse,
    psnr,
    snr,
)
from lmc_atomi_torch.eval.wasserstein import (
    exact_w2,
    exact_w2_assignment,
    pairwise_sq_dists,
    sinkhorn_w2,
    sliced_w2,
    w2_prefix_curve,
    w2_prefix_curve_exact,
)

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "split_rhat",
    "acceptance_rate",
    "effective_sample_mask",
    "mse",
    "psnr",
    "snr",
    "exact_w2",
    "exact_w2_assignment",
    "pairwise_sq_dists",
    "sinkhorn_w2",
    "sliced_w2",
    "w2_prefix_curve",
    "w2_prefix_curve_exact",
]
