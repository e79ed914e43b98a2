"""Linear operators, wavelets, TV proxes (with CUDA kernel 1), functionals,
proximal operators and Bregman maps."""
from lmc_atomi_torch.ops import bregman, functionals, linops, ncvx_tv, prox, tv

__all__ = ["bregman", "functionals", "linops", "ncvx_tv", "prox", "tv"]
