"""Linear operators (with the Radon transform), wavelets, TV proxes (with CUDA
kernel 1), functionals, Moreau envelopes, proximal operators and Bregman
maps."""
from lmc_atomi_torch.ops import bregman, functionals, linops, moreau, ncvx_tv, prox, radon, tv

__all__ = ["bregman", "functionals", "linops", "moreau", "ncvx_tv", "prox", "radon", "tv"]
