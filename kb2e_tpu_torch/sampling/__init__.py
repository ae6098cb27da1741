"""Negative sampling: membership indices and the corruption sampler."""
