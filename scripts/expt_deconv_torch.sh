#!/bin/bash
# Deconvolution: MAP + both samplers on the PyTorch port (line for line
# scripts/expt_deconv.sh; the CLI runs on the card unless --device cpu is
# given)
set -e
cd "$(dirname "$0")/.."
python -m lmc_atomi_torch.experiments.deconv --compute_map true --niter_map 1000
python -m lmc_atomi_torch.experiments.deconv --alg ULPDA --n_steps 1000
python -m lmc_atomi_torch.experiments.deconv --alg MYULA --n_steps 1000
