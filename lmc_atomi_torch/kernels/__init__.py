"""Sampler kernels: MYULA, ULPDA, ULA and MALA over functionals, and the
fused block kernels 2-5 with their plain versions and runners."""
