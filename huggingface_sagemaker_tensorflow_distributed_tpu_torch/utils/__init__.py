"""Logging, results files and timing for the port's trainer."""
