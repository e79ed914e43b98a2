"""Multi-chain reductions (counterpart of ``lmc_atomi_tpu/parallel``)."""
