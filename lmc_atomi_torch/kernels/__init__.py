"""Sampler kernels: MYULA, ULPDA, ULA and MALA over functionals, the fused
block kernels 2-5 and the large-image tile kernels 6-8, with their plain
versions and runners; the mixtures' Langevin (PULA, IHPULA, MLA) and
proximal (PGLD, MYULA, MYMALA, PP-ULA, FBULA, LBMUMLA) kernels; PnP-ULA
and the score-ULA samplers of the learned priors; the SG-MCMC family."""
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at
from lmc_atomi_torch.kernels.imaging import (
    myula_imaging,
    pnp_ula,
    score_ula,
    score_ula_pc,
    ulpda,
)
from lmc_atomi_torch.kernels.langevin import ihpula, mala, mla, pula, sqrtm_psd, ula
from lmc_atomi_torch.kernels.myula_cuda import myula_imaging_fused
from lmc_atomi_torch.kernels.myula_fused import (
    myula_imaging_sep_fused,
    run_myula_tv_fused,
    run_myula_tv_fused_packed,
    sep_fused_supported,
)
from lmc_atomi_torch.kernels.myula_tiled import run_myula_tv_tiled
from lmc_atomi_torch.kernels.proximal import fbula, lbmumla, mymala, myula, pgld, ppula
from lmc_atomi_torch.kernels.sgmcmc import (
    contour_spgld,
    csgld,
    csgld_importance_resample,
    cyclical_cosine_schedule,
    cyclical_sgld,
    cyclical_spgld,
    minibatch_grad_estimator,
    msgld,
    mysgld,
    polynomial_schedule,
    sgld,
    spgld,
    ssgld,
)
from lmc_atomi_torch.kernels.ulpda_fused import (
    run_ulpda_fused,
    run_ulpda_fused_packed,
    ulpda_fused_supported,
    ulpda_sep_fused,
)
from lmc_atomi_torch.kernels.ulpda_tiled import run_ulpda_tv_tiled
from lmc_atomi_torch.kernels.wavelet_fused import (
    run_myula_wavelet_fused,
    run_ulpda_wavelet_fused,
)

__all__ = [
    "sgld",
    "msgld",
    "cyclical_sgld",
    "csgld",
    "csgld_importance_resample",
    "spgld",
    "ssgld",
    "mysgld",
    "cyclical_spgld",
    "contour_spgld",
    "polynomial_schedule",
    "cyclical_cosine_schedule",
    "minibatch_grad_estimator",
    "Kernel",
    "stepsize_at",
    "ula",
    "mala",
    "pula",
    "ihpula",
    "mla",
    "sqrtm_psd",
    "pgld",
    "myula",
    "mymala",
    "ppula",
    "fbula",
    "lbmumla",
    "ulpda",
    "myula_imaging",
    "pnp_ula",
    "score_ula",
    "score_ula_pc",
    "myula_imaging_fused",
    "myula_imaging_sep_fused",
    "run_myula_tv_fused",
    "run_myula_tv_fused_packed",
    "run_myula_tv_tiled",
    "run_myula_wavelet_fused",
    "run_ulpda_wavelet_fused",
    "sep_fused_supported",
    "ulpda_sep_fused",
    "run_ulpda_fused",
    "run_ulpda_fused_packed",
    "run_ulpda_tv_tiled",
    "ulpda_fused_supported",
]
