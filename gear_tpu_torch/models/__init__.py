"""Llama-family model and checkpoint loader."""
