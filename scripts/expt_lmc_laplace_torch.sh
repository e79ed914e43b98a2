#!/bin/bash
# Sweep: Laplacian-mixture LMC on the PyTorch port (line for line
# scripts/expt_lmc_laplace.sh; the CLIs run on the card unless --device cpu
# is given)
set -e
cd "$(dirname "$0")/.."
for gamma in 0.1 0.05; do
  for lamda in 0.1 0.01; do
    for n in 1 2 3 4 5; do
      python -m lmc_atomi_torch.experiments.laplace_mixtures \
        --gamma_ula "$gamma" --gamma_mala "$gamma" --gamma_pula "$gamma" \
        --gamma_ihpula "$gamma" --gamma_mla "$gamma" \
        --lamda "$lamda" --n "$n" --k 50000
    done
  done
done
