"""Test images."""
