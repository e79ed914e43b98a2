"""Chain runners."""
