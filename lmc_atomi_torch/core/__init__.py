"""Sampler state, counter-based noise and streaming statistics."""
