"""Workload entry points: the experiment CLIs."""
from lmc_atomi_torch.experiments import configs, figures
from lmc_atomi_torch.experiments.ct import ct_tv_myula
from lmc_atomi_torch.experiments.deconv import prox_lmc_deconv
from lmc_atomi_torch.experiments.denoise import l1_denoise_myula
from lmc_atomi_torch.experiments.inpainting import wavelet_inpainting
from lmc_atomi_torch.experiments.laplace_mixtures import lmc_laplacian_mixture
from lmc_atomi_torch.experiments.mixtures import lmc_gaussian_mixture
from lmc_atomi_torch.experiments.pnp import pnp_ula_deblur
from lmc_atomi_torch.experiments.prox_mixtures import prox_lmc_gaussian_mixture
from lmc_atomi_torch.experiments.sgld_runs import sgld_grid_mixture

__all__ = [
    "configs",
    "figures",
    "prox_lmc_deconv",
    "lmc_laplacian_mixture",
    "lmc_gaussian_mixture",
    "prox_lmc_gaussian_mixture",
    "sgld_grid_mixture",
    "wavelet_inpainting",
    "pnp_ula_deblur",
    "ct_tv_myula",
    "l1_denoise_myula",
]
