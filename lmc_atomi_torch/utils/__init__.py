"""Test images and the command-line wrapper."""
