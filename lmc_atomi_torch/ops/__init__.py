"""Linear operators, TV proxes (with CUDA kernel 1) and functionals."""
