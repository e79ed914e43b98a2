#!/bin/bash
# Round-2 workloads beyond the reference's four, on the PyTorch port (line
# for line scripts/expt_extras.sh; the CLIs run on the card unless --device
# cpu is given): natural-image deconv, wavelet inpainting (Haar vs D4/D8),
# sparse-view CT (TV MAP + PnP), PnP-ULA credible intervals.
set -e
cd "$(dirname "$0")/.."

# natural-image deconvolution (einstein), all three branches
python -m lmc_atomi_torch.experiments.deconv --image einstein --compute_map true --niter_map 1000 --collect_metrics false
python -m lmc_atomi_torch.experiments.deconv --image einstein --alg ULPDA --n_steps 1000 --collect_metrics false
python -m lmc_atomi_torch.experiments.deconv --image einstein --alg MYULA --n_steps 1000 --collect_metrics false

# wavelet inpainting: Haar vs Daubechies-4 vs Daubechies-8
for w in haar d4 d8; do
  python -m lmc_atomi_torch.experiments.inpainting --wavelet $w --n_steps 2000
done

# sparse-view CT: TV posterior + TV MAP + learned DnCNN-PnP prior
python -m lmc_atomi_torch.experiments.ct --size 128 --n_angles 30 --n_steps 2000

# PnP-ULA credible-interval maps, 1024 chains in 64-chain blocks
# (one process; the block-per-process resumable variant is
# scripts/expt_pnp1024_torch.py)
python -m lmc_atomi_torch.experiments.pnp --size 256 --n_chains 1024 --chain_block 64 --n_steps 2000 --burn_in 200
