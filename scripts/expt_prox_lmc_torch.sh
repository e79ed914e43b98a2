#!/bin/bash
# Sweep: proximal LMC on mixture x Laplace prior, on the PyTorch port
# (line for line scripts/expt_prox_lmc.sh; the CLIs run on the card unless
# --device cpu is given)
set -e
cd "$(dirname "$0")/.."
for gamma in 0.05 0.01; do
  for lamda in 0.01 0.001; do
    for n in 1 2 3 4 5; do
      python -m lmc_atomi_torch.experiments.prox_mixtures \
        --gamma_pgld "$gamma" --gamma_myula "$gamma" --gamma_mymala "$gamma" \
        --gamma_ppula "$gamma" --gamma_fbula "$gamma" --gamma_lbmumla "$gamma" \
        --lamda "$lamda" --n "$n" --k 10000
    done
  done
done
