"""Sampler kernels: MYULA over functionals and the fused block (CUDA kernel 2)."""
