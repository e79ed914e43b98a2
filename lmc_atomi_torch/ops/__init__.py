"""Linear operators, wavelets, TV proxes (with CUDA kernel 1) and
functionals."""
