"""Quantization and low-rank primitives."""
