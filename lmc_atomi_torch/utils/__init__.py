"""Test images and the command-line wrapper."""
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_torch.utils.images import phantom

__all__ = ["auto_cli", "phantom"]
