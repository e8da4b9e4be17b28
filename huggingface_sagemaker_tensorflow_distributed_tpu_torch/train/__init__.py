"""Optimizer, trainer and training CLI of the port."""
