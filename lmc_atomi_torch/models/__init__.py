"""Mixture targets, the 25-mode grid mixture of the SG-MCMC samplers, the
composite mixture x Laplace-prior target and the multivariate Laplace
distribution; the learned priors are the submodules
``models.dncnn`` and ``models.score`` (torch.nn nets and their training)."""
from lmc_atomi_torch.models.composite import LaplacePrior, MixtureWithLaplacePrior
from lmc_atomi_torch.models.gaussian_mixture import GaussianMixture
from lmc_atomi_torch.models.grid_mixture import GridGaussianMixture
from lmc_atomi_torch.models.laplace_mixture import LaplaceMixture
from lmc_atomi_torch.models.mvlaplace import MultivariateLaplace

__all__ = [
    "GaussianMixture",
    "GridGaussianMixture",
    "LaplaceMixture",
    "LaplacePrior",
    "MixtureWithLaplacePrior",
    "MultivariateLaplace",
]
