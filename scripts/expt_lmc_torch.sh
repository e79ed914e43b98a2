#!/bin/bash
# Sweep: Gaussian-mixture LMC over step sizes x mixture sizes, on the
# PyTorch port (line for line scripts/expt_lmc.sh; the CLIs run on the card
# unless --device cpu is given)
set -e
cd "$(dirname "$0")/.."
for gamma in 0.1 0.05 0.01; do
  for n in 1 2 3 4 5; do
    python -m lmc_atomi_torch.experiments.mixtures \
      --gamma_ula "$gamma" --gamma_mala "$gamma" --gamma_pula "$gamma" \
      --gamma_ihpula "$gamma" --gamma_mla "$gamma" \
      --n "$n" --k 10000
  done
done
